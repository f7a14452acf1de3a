"""The port's launch tooling (``sharding/specs.py``, ``launch/{mesh,
inputs,roofline,dryrun}.py``, ``benchmarks/roofline_report.py``) against
the reference's, on the CPU.

The spec tables are held leaf for leaf on every arch of ``configs/`` at
full width, on the single-pod (16, 16) and multi-pod (2, 16, 16) meshes;
the reference gets a mesh that has only ``.shape`` (jax's ``AbstractMesh``
constructor changed signature) and its leaf shapes from
``jax.eval_shape``, the port its own from the ``meta`` device: nothing is
allocated.  ``round_decomposition`` and ``model_flops_per_round`` are
exactly the reference's; the counted FLOPs are exact on a linear layer and
one attention block."""
import dataclasses
import json
import math
import types

import jax
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import ARCHS as R_ARCHS
from repro.configs import SHAPES as R_SHAPES
from repro.configs.base import FedConfig as RFedConfig
from repro.configs.base import RunConfig as RRunConfig
from repro.launch import inputs as RI
from repro.launch import roofline as RR
from repro.launch.serve import cache_shapes as r_cache_shapes
from repro.models.registry import _param_shapes
from repro.sharding import specs as RS
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import FedConfig, RunConfig
from repro_torch.core.tree import tree_map_with_path
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as I
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import (make_card_mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.launch.serve import cache_shapes
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.registry import get_model
from repro_torch.sharding import specs as S

MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}


def duck(mesh):
    """A mesh for the reference's rules: only ``.shape``."""
    return types.SimpleNamespace(shape=dict(mesh.shape))


def ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {RS._path_keys(p): tuple(leaf.shape) for p, leaf in flat}


def port_leaves(tree):
    out = {}
    tree_map_with_path(lambda p, t: out.__setitem__(p, tuple(t.shape)),
                       tree)
    return out


def test_meshes_are_the_references_shapes():
    assert dict(make_production_mesh().shape) == {"data": 16, "model": 16}
    assert dict(make_production_mesh(multi_pod=True).shape) == {
        "pod": 2, "data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    for m in (make_host_mesh(), make_card_mesh()):
        assert dict(m.shape) == {"data": 1, "model": 1} and m.size == 1


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_and_cache_specs_equal_the_references(arch):
    rcfg, cfg = R_ARCHS[arch], ARCHS[arch]
    want_shapes = ref_leaves(_param_shapes(rcfg))
    params = get_model(cfg).init(0, cfg, device="meta")
    got_shapes = port_leaves(params)
    assert got_shapes == want_shapes
    B, Lc = 8, 64
    want_cache = ref_leaves(r_cache_shapes(rcfg, B, Lc))
    got_cache = port_leaves(cache_shapes(cfg, B, Lc))
    assert got_cache == want_cache
    for mesh in MESHES.values():
        rm = duck(mesh)
        for path, shape in got_shapes.items():
            for mode in ("train", "serve"):
                assert S.spec_for_param(path, shape, mesh, mode=mode) == \
                    tuple(RS.spec_for_param(path, shape, rm, mode=mode)), \
                    (path, mode)
            assert S.spec_for_param(path, shape, mesh, fsdp=("pod", "data"),
                                    tp=None) == tuple(RS.spec_for_param(
                                        path, shape, rm, ("pod", "data"),
                                        None)), path
        for path, shape in got_cache.items():
            assert S.spec_for_cache(path, shape, mesh) == \
                tuple(RS.spec_for_cache(path, shape, rm)), path
    # the tree forms take the port's tree whole
    specs = S.param_shardings(params, MESHES["single"])
    assert port_leaves(params).keys() == {
        p for p in got_shapes} and isinstance(specs, dict)


def test_batch_specs_equal_the_references():
    for mesh in MESHES.values():
        rm = duck(mesh)
        for mp in (False, True):
            assert S.train_batch_spec(mesh, mp) == tuple(
                RS.train_batch_spec(rm, mp))
            for batch in (1, 16, 32, 64, 128, 512):
                assert S.serve_batch_spec(mesh, batch, mp) == tuple(
                    RS.serve_batch_spec(rm, batch, mp))


def test_round_decomposition_equals_the_references():
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        for mp in (False, True):
            for R_, H in ((4, 4), (2, 2), (8, 1), (16, 4)):
                mesh = MESHES["multi" if mp else "single"]
                f, rf = (FedConfig(clients_per_round=R_, local_steps=H),
                         RFedConfig(clients_per_round=R_, local_steps=H))
                try:
                    want = RI.round_decomposition(R_SHAPES[name], rf,
                                                  duck(mesh), mp)
                except AssertionError:
                    with pytest.raises(AssertionError):
                        I.round_decomposition(SHAPES[name], f, mesh, mp)
                    continue
                assert I.round_decomposition(SHAPES[name], f, mesh,
                                             mp) == want


def test_model_flops_per_round_equals_the_references():
    """Every arch × shape × distill.  The parameter counts are each
    package's own, held equal once an arch; the shape loop then gives both
    functions one stand-in config with those counts."""
    for arch in sorted(ARCHS):
        cfg, rcfg = ARCHS[arch], R_ARCHS[arch]
        n, rn = cfg.param_count(), rcfg.param_count()
        assert n == rn, arch
        na = cfg.active_param_count() if cfg.moe is not None else n
        if cfg.moe is not None:
            assert na == rcfg.active_param_count(), arch
        stand_in = types.SimpleNamespace(moe=cfg.moe, param_count=lambda: n,
                                         active_param_count=lambda: na)
        for name in SHAPES:
            for distill in (False, True):
                got = R.model_flops_per_round(stand_in, SHAPES[name],
                                              FedConfig(distill=distill))
                want = RR.model_flops_per_round(
                    stand_in, R_SHAPES[name], RFedConfig(distill=distill))
                assert got == want, (arch, name, distill)
            assert R.model_flops_per_round(stand_in, SHAPES[name]) == \
                RR.model_flops_per_round(stand_in, R_SHAPES[name])
    # one arch through its real config, as the dry-run calls it
    assert R.model_flops_per_round(ARCHS["qwen3-4b"], SHAPES["train_4k"]) \
        == RR.model_flops_per_round(R_ARCHS["qwen3-4b"],
                                    R_SHAPES["train_4k"])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "whisper-small",
                                  "internvl2-26b"])
def test_inputs_equal_the_references_on_the_host_mesh(arch):
    """Shapes, dtypes and specs of every input, the state's leaves too, at
    reduced width on the (1, 1) host mesh (the reference's needs a real
    jax mesh for its shardings)."""
    rcfg, cfg = R_ARCHS[arch].reduced(), ARCHS[arch].reduced()
    rmesh = jax.make_mesh((1, 1), ("data", "model"))
    mesh = make_host_mesh()
    shape, rshape = SHAPES["train_4k"], R_SHAPES["train_4k"]
    fed = FedConfig(clients_per_round=4, local_steps=4, compressor="topk",
                    error_feedback=True)
    rfed = RFedConfig(clients_per_round=4, local_steps=4, compressor="topk",
                      error_feedback=True)

    def same(got, got_specs, want):
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == want[k].shape, k
            assert str(got[k].dtype).split(".")[-1] == str(
                want[k].dtype), k
            assert got[k].device.type == "meta"
            assert got_specs[k] == tuple(want[k].sharding.spec), k
    same(*I.train_inputs(cfg, shape, fed, mesh, False),
         RI.train_inputs(rcfg, rshape, rfed, rmesh, False))
    same(*I.prefill_inputs(cfg, SHAPES["prefill_32k"], mesh, False),
         RI.prefill_inputs(rcfg, R_SHAPES["prefill_32k"], rmesh, False))
    (cache, tok, pos, act), (cspecs, tspec, pspec, aspec) = I.decode_inputs(
        cfg, SHAPES["decode_32k"], mesh, False)
    rcache, rtok, rpos, ract = RI.decode_inputs(
        rcfg, R_SHAPES["decode_32k"], rmesh, False)
    assert port_leaves(cache) == ref_leaves(rcache)
    assert tuple(tok.shape) == rtok.shape and tspec == tuple(
        rtok.sharding.spec)
    assert tuple(pos.shape) == rpos.shape and pspec == tuple(
        rpos.sharding.spec)
    assert (act is None) == (ract is None)
    state, specs = I.state_inputs(cfg, fed, RunConfig(), mesh)
    rstate = RI.state_inputs(rcfg, rfed, RRunConfig(), rmesh)
    for key in ("params", "server", "clients"):
        assert port_leaves(state[key]) == ref_leaves(rstate[key]), key
    assert I.state_nbytes(state) == sum(
        math.prod(x.shape) * x.dtype.itemsize
        for k in ("params", "server", "clients")
        for x in jax.tree.leaves(rstate[k]))
    # one counter: on a mesh of one device its share is the whole state
    assert I.state_nbytes(state, specs, mesh) == I.state_nbytes(state)


def test_roofline_terms_on_given_numbers():
    peaks = R.H100_SXM
    rl = R.analyze(R.Counts(989e12, 3.35e12 * 2), make_card_mesh(),
                   model_flops_per_chip=2 * 989e12, per_device_hbm=2**30,
                   peaks=peaks)
    assert rl.compute_s == pytest.approx(2.0)
    assert rl.compute_s_hlo == pytest.approx(1.0)
    assert rl.memory_s == pytest.approx(2.0 * 3.35e12 / peaks.hbm_bw)
    assert rl.collective_s == 0.0 and rl.dominant in ("compute", "memory")
    rl = R.analyze(R.Counts(1e12, 3.35e13), make_card_mesh(), peaks=peaks)
    assert rl.dominant == "memory" and rl.memory_s == pytest.approx(10.0)
    d = rl.as_dict()
    assert set(RR.Roofline(1, 1, 0, 1, RR.parse_collectives(""), 0)
               .as_dict()) <= set(d)
    assert d["collective_counts"] == {c: 0 for c in R._COLLECTIVES}
    assert d["per_device_hbm_gb"] == 0.0
    # a mesh of several devices: each takes an even share
    rl = R.analyze(R.Counts(512e12, 512e9), make_production_mesh(
        multi_pod=True), peaks=peaks)
    assert rl.flops == 1e12 and rl.chips == 512


def test_peaks_follow_the_card_name():
    assert R.peaks_for("NVIDIA H100 80GB HBM3") == R.H100_SXM
    assert R.peaks_for("NVIDIA H100 NVL") == R.H100_NVL
    assert R.peaks_for("NVIDIA H100 PCIe") == R.H100_PCIE
    assert (R.H100_SXM.bf16_flops, R.H100_SXM.fp32_flops,
            R.H100_SXM.hbm_bw, R.H100_SXM.link_bw) == (989e12, 67e12,
                                                        3.35e12, 900e9)
    other = R.peaks_for("NVIDIA A100")
    assert other.bf16_flops == 989e12 and "unknown" in other.name


def test_counted_flops_are_exact_for_a_linear_layer_and_attention():
    cfg = dataclasses.replace(ARCHS["qwen3-4b"].reduced(), n_layers=1)
    B, Lq, d, f = 2, 16, 32, 48
    p = L.linear_init(None, d, f, device="meta")
    x = torch.empty((B, Lq, d), device="meta")
    _, c = R.count(L.linear, p, x)
    assert c.flops == 2 * B * Lq * d * f
    assert c.bytes >= (B * Lq * d + d * f + B * Lq * f) * 4
    # one attention block: q, k, v, o projections + QKᵀ + PV
    ap = A.gqa_init(None, cfg, device="meta")
    D_, H, Hk = cfg.resolved_head_dim, cfg.n_heads, cfg.n_kv_heads
    x = torch.empty((B, Lq, cfg.d_model), device="meta")
    with FlopCounterMode(display=False) as fc:
        A.gqa_forward(ap, x, cfg, 0)
    dm = cfg.d_model
    proj = 2 * B * Lq * dm * (H * D_ + 2 * Hk * D_) + 2 * B * Lq * H * D_ * dm
    scores = 2 * 2 * B * H * Lq * Lq * D_
    assert fc.get_total_flops() == proj + scores


def test_counted_flops_split_by_operand_dtype():
    """``Counts.flops_by_dtype`` sums to the total: bf16 products apart
    from fp32 ones, whose peaks differ."""
    a16 = torch.empty((8, 32), dtype=torch.bfloat16, device="meta")
    b16 = torch.empty((32, 16), dtype=torch.bfloat16, device="meta")
    a32, b32 = a16.float(), b16.float()
    _, c = R.count(lambda: (a16 @ b16, torch.bmm(a32[None], b32[None]),
                            a32.sum()))
    assert c.flops_by_dtype == {"bfloat16": 2 * 8 * 32 * 16,
                                "float32": 2 * 8 * 32 * 16}
    assert c.flops == sum(c.flops_by_dtype.values())
    assert R.H100_SXM.for_dtype("bfloat16") == 989e12
    assert R.H100_SXM.for_dtype("float32") == 67e12
    assert R.H100_SXM.for_dtype("int8") is None


def test_chip_smoke_sorts_gemm_kernels_by_the_cores_they_run_on():
    """Phase 15's profile puts each GEMM kind on the tensor or the CUDA
    cores by its name; phase 16 (b) divides each dtype's FLOPs by that."""
    import importlib.util
    import pathlib
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).parents[1] / "chip_smoke.py")
    C = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(C)
    assert C.gemm_class("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT") \
        == "tensor cores"
    assert C.gemm_class("sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize64x"
                        "64x8_stage3_warpsize1x4x1_ffma_aligna4") \
        == "cuda cores"
    assert C.gemm_class("void at::native::vectorized_elementwise_kernel<4, "
                        "at::native::CUDAFunctor_add<float>>") is None
    assert set(C.DTYPE_GEMM_CLASS.values()) == {"tensor cores", "cuda cores"}


def test_composed_round_equals_the_whole_round():
    """a + c·CS + s·CS·H from three short rounds equals the counts of the
    whole round, FLOPs, bytes and ops."""
    cfg = ARCHS["qwen3-4b"].reduced()
    fed = FedConfig(strategy="fedadc", clients_per_round=2, local_steps=3)
    run = RunConfig(remat="full")
    batch = {k: torch.empty((1, 2, 3, 2, 32), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    got = D.count_train_round(cfg, fed, run, batch, compose=True)
    want = D.count_train_round(cfg, fed, run, batch, compose=False)
    assert (got.flops, got.bytes) == (want.flops, want.bytes)
    assert got.ops == want.ops
    assert got.flops_by_dtype == want.flops_by_dtype
    # a dense arch's round: counted at or above 6·N·D (remat recomputes)
    from repro_torch.configs.base import ShapeConfig
    shape = ShapeConfig("train_small", 32, 2 * 3 * 2, "train")
    assert got.flops >= R.model_flops_per_round(cfg, shape, fed)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k",
                                   "long_500k"])
def test_lower_one_on_a_reduced_config(shape, tmp_path):
    cfg = ARCHS["zamba2-1.2b"].reduced()
    res = D.lower_one("zamba2-1.2b", shape, mcfg=cfg, verbose=False,
                      peaks=R.H100_SXM)
    assert res["status"] == "ok"
    assert res["model_flops"] == R.model_flops_per_round(
        cfg, SHAPES[shape], D._fed_for(None, "zamba2-1.2b"))
    assert res["flops"] > 0 and res["bytes"] > 0
    assert res["dominant"] in ("compute", "memory")
    assert res["collective_s"] == 0.0 and res["mesh"] == [1, 1]
    if shape == "train_4k":
        # remat recomputes the forward: counted at or above 6·N·D
        assert res["flops"] >= res["model_flops"]
        assert res["per_device_hbm_gb"] * 2**30 == I.state_nbytes(
            I.state_inputs(cfg, D._fed_for(None, ""), D._run_for(""),
                           make_card_mesh())[0])
    if shape != "train_4k":
        multi = D.lower_one("zamba2-1.2b", shape, multi_pod=True, mcfg=cfg,
                            verbose=False, peaks=R.H100_SXM)
        assert multi["mesh"] == [2, 16, 16]
        assert multi["flops"] == pytest.approx(res["flops"] / 512)


def test_dryrun_cli_and_roofline_report_rows_equal_the_references(
        tmp_path, monkeypatch, capsys):
    """The CLI appends one line a cell; the port's report and the
    reference's print the same rows from the same file."""
    out = tmp_path / "single.jsonl"
    assert D.main(["--arch", "zamba2-1.2b", "--shape",
                   "decode_32k,long_500k", "--device", "meta", "--out",
                   str(out)]) == 0
    assert D.main(["--arch", "whisper-small", "--shape", "long_500k",
                   "--out", str(out)]) == 0
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [(r["arch"], r["shape"], r["status"]) for r in lines] == [
        ("zamba2-1.2b", "decode_32k", "ok"), ("zamba2-1.2b", "long_500k",
                                              "ok"),
        ("whisper-small", "long_500k", "skipped")]
    import benchmarks.roofline_report as rmod
    from repro_torch.benchmarks import roofline_report as pmod
    missing = str(tmp_path / "none.jsonl")
    monkeypatch.setattr(rmod, "RESULTS", [("singlepod", str(out)),
                                          ("multipod", missing)])
    want = rmod.main([])
    got = pmod.main([], results=[("singlepod", str(out)),
                                 ("multipod", missing)])
    assert got == want and len(got) == 3
    assert got[0].startswith("roofline.singlepod.zamba2-1.2b.decode_32k,")
