"""The plain references against the port at tiny widths on the CPU: the
same parameter trees, the same losses and gradients, and whole FedADC
rounds of each cell within its limits."""
from __future__ import annotations

import json
import time

import pytest
import torch

from perfbench_tiny import ROOT, TINY_ZAMBA
from perfbench import bench
from perfbench.reference import resnet18, zamba2
from perfbench.tree import flatten, unflatten


def port_zamba(model):
    from perfbench.engines.pod import model_config
    return model_config({"name": "tiny", "source": "test", "model": model},
                        zamba2.pattern(model))


def shapes(tree):
    return {k: tuple(v.shape) for k, v in flatten(tree).items()}


@pytest.mark.parametrize("which", ["tiny", "full"])
def test_zamba2_layout_is_the_ports_parameter_tree(which):
    from repro_torch.models import transformer
    model = TINY_ZAMBA if which == "tiny" else json.loads(
        (ROOT / "perfbench/configs/zamba2-1.2b.json").read_text())["model"]
    port = transformer.init(0, port_zamba(model), device="meta")
    assert shapes(port) == {k: s for k, (s, _, _) in
                            zamba2.layout(model).items()}


def test_resnet18_layout_is_the_ports_parameter_tree():
    from repro_torch.models.vision import resnet18_init
    port = resnet18_init(0, n_classes=100, device="cpu")
    assert shapes(port) == {k: s for k, (s, _, _) in
                            resnet18.layout({"n_classes": 100}).items()}


def _grads(loss_fn, params):
    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    val = loss_fn(leaves)
    gs = torch.autograd.grad(val, list(leaves.values()))
    return float(val.detach()), dict(zip(leaves, gs))


def test_zamba2_loss_and_gradients_match_the_port_in_fp32():
    from repro_torch.models import transformer
    cfg = port_zamba(TINY_ZAMBA)
    params = zamba2.make_params(TINY_ZAMBA, 7, "cpu")
    gen = torch.Generator().manual_seed(3)
    tok = torch.randint(0, TINY_ZAMBA["vocab_size"], (2, 64), generator=gen)
    batch = {"tokens": tok, "labels": tok}
    lr, gr = _grads(lambda p: zamba2.loss(p, batch, TINY_ZAMBA), params)
    lp, gp = _grads(lambda p: transformer.loss_fn(unflatten(p), batch,
                                                  cfg)[0], params)
    assert abs(lr - lp) <= 1e-5 * abs(lr)
    for k in gr:
        scale = float(gr[k].abs().max()) + 1e-12
        assert float((gr[k] - gp[k]).abs().max()) <= 1e-4 * scale, k


def test_resnet18_logits_match_the_port():
    from repro_torch.models.vision import resnet18_apply
    model = {"n_classes": 10}
    params = resnet18.make_params(model, 5, "cpu")
    x = torch.randn(3, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    want = resnet18.logits(params, x)
    got = resnet18_apply(unflatten(params), x)
    assert float((want - got).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("workload", ["zamba2-1.2b.fedadc",
                                      "resnet18-cifar100.fedadc"])
def test_whole_rounds_match_the_reference_within_the_cells_limits(
        tiny, workload):
    out = bench.run_cell(tiny, workload, 2 ** 31 + 99, 0.2, False,
                         time.perf_counter(), device="cpu",
                         bench=tiny / "perfbench")
    assert out["result"]["correct"], out["checks"]
    names = {c["name"] for c in out["checks"]}
    assert names == {"loss", "grad", "change"}
    assert list(out["result"])[-1] == "checks"


@pytest.mark.parametrize("name", ["zamba2-1.2b", "resnet18-cifar100"])
def test_a_configurations_parameter_count_is_its_layouts(name):
    import math
    cfg = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
    ref = {"zamba2": zamba2, "resnet18": resnet18}[cfg["reference"]]
    assert cfg["params"] == sum(math.prod(s) for s, _, _ in
                                ref.layout(cfg["model"]).values())
