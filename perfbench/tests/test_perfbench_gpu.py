"""On the card: a tiny copy of each cell runs through the harness with the
port's CUDA kernels, the unbroken run is correct and each control is
not.
Skips without a card; on the card:
``python -m pytest --noconftest -m gpu perfbench/tests/test_perfbench_gpu.py``
runs it (``--noconftest`` keeps the repo's test configuration out; this
file imports its own helpers)."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from perfbench_tiny import copy_checkout, write_tiny  # noqa: E402

CELLS = ["zamba2-1.2b.fedadc", "resnet18-cifar100.fedadc"]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_cells_on_the_card(card, tmp_path, workload):
    from perfbench import bench
    root = copy_checkout(tmp_path)
    write_tiny(root)
    # the tiny ResNet-18's training runs away (its loss rises), so TF32's
    # rounding in the convolutions outgrows limits set at the cell's own
    # size: the tiny copy checks the path with fp32 convolutions
    conf = root / "perfbench" / "configs" / "resnet18-cifar100.json"
    cfg = json.loads(conf.read_text())
    cfg["precision"]["tf32"]["cudnn"] = False
    conf.write_text(json.dumps(cfg))

    def run(**kw):
        return bench.run_cell(root, workload, 2 ** 31 + 17, 0.5, True,
                              time.perf_counter(), device="cuda",
                              bench=root / "perfbench", **kw)
    out = run()
    assert out["result"]["correct"], out["checks"]
    assert out["result"]["device"]["platform"] == "gpu"
    controls = json.loads((root / "perfbench" / "configs" / (
        workload.rsplit(".", 1)[0] + ".json")).read_text())["controls"]
    for name in controls:
        assert not run(reference=name)["result"]["correct"], name
