"""The metric readers on a canned trace and window."""
from __future__ import annotations

import pytest

from perfbench_tiny import ROOT
from perfbench import manifest
from perfbench.bench import Context
from perfbench.trace import Trace, breakdown
from perfbench.yardstick.kernel_bytes import sweep
from perfbench.yardstick.peaks import H100_SXM

BENCH = ROOT / "perfbench"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64"
CONV = "cutlass__5x_cudnn::Kernel<cutlass_tensorop_s1688fprop_optimized>"
AXPY = "void (anonymous namespace)::axpy_leaves_kernel<float>(AxpyTable, float)"
SERVER = "void server_update_leaves_kernel<float>(UpdateTable, float, float)"
ELEM = "void at::native::vectorized_elementwise_kernel<4, CUDAFunctor_add>"
COPY = "Memcpy HtoD (Pageable -> Device)"

# two rounds, times in seconds from the traced window's start
EVENTS = [(GEMM, 0.000, 0.010), (ELEM, 0.012, 0.020), (CONV, 0.015, 0.025),
          (AXPY, 0.030, 0.032), (SERVER, 0.032, 0.033), (COPY, 0.040, 0.041),
          (GEMM, 0.050, 0.060), (ELEM, 0.060, 0.070), (AXPY, 0.080, 0.082),
          (SERVER, 0.082, 0.083)]
SPANS = [("stage", 0.033, 0.045), ("engine", 0.045, 0.083)]


class FakeEngine:
    def __init__(self, sweeps):
        self._sweeps = sweeps

    def flops_per_round(self):
        return 2.0e12

    def sweeps(self):
        return self._sweeps


def ctx(trace=True, sweeps=None):
    cell = manifest.cell(ROOT, "resnet18-cifar100.fedadc")
    window = {"rounds": 4, "seconds": 2.0, "peak_bytes": 3 * 2 ** 30,
              "host_ms": 400.0, "stage_ms": 80.0}
    tr = Trace(EVENTS, 0.100, 2, SPANS) if trace else None
    return Context(cell, FakeEngine(sweeps), 12.5, window, tr, H100_SXM)


def read(name, c):
    return manifest.module(BENCH, "metrics", name).read(c)


def test_end_to_end_readers():
    c = ctx()
    assert read("round_s", c) == 0.5
    assert read("peak_mem_gib", c) == 3.0
    assert read("setup_s", c) == 12.5


def test_host_readers():
    c = ctx()
    assert read("host_ms_per_round", c) == 100.0
    assert read("stage_ms_per_round", c) == 20.0
    c.window["stage_ms"] = 0.0
    assert read("stage_ms_per_round", c) is None


def test_device_time_by_class():
    c = ctx()
    # GEMMs: 10 + 10 + 10 ms (the convolution included) over 2 rounds
    assert read("gemm_ms_per_round", c) == pytest.approx(15.0)
    # the port's kernels: 2 + 1 + 2 + 1 ms
    assert read("kernels_ms_per_round", c) == pytest.approx(3.0)
    # the rest: 8 + 1 + 10 ms
    assert read("other_ms_per_round", c) == pytest.approx(9.5)


def test_idle_share_takes_the_union_of_overlapping_operations():
    c = ctx()
    # busy: [0, 10] + [12, 25] + [30, 33] + [40, 41] + [50, 70] + [80, 83]
    assert c.trace.busy_s == pytest.approx(0.050)
    assert read("idle_share", c) == pytest.approx(50.0)


def test_readers_return_nothing_without_a_trace():
    c = ctx(trace=False)
    for name in ("gemm_ms_per_round", "other_ms_per_round",
                 "kernels_ms_per_round", "kernels_roofline", "idle_share"):
        assert read(name, c) is None


def test_kernels_roofline_is_bound_time_over_measured_time():
    n = 1_000_000
    sweeps = [sweep("fused_axpy", 1, elements=n, itemsize=4),
              sweep("server_update", 1, elements=n, theta_itemsize=4),
              sweep("weighted_reduce", 1, elements=n, rows=2, itemsize=4)]
    c = ctx(sweeps=sweeps)
    bound = (12 * n + 20 * n) / H100_SXM.hbm      # the reduce never ran
    measured = 0.006 / 2                          # a round
    assert read("kernels_roofline", c) == pytest.approx(
        100 * bound / measured)
    assert read("kernels_roofline", ctx(sweeps=None)) is None


def test_mfu_is_model_flops_over_round_time_against_the_peak():
    c = ctx()
    assert read("mfu", c) == pytest.approx(100 * 2.0e12 / 0.5 / 494.5e12)


def test_breakdown_names_gaps_by_the_open_span():
    b = breakdown(Trace(EVENTS, 0.100, 2, SPANS))
    assert b["device_ops"][0] == [GEMM, pytest.approx(0.020)]
    gaps = dict((round(s, 6), n) for n, s in b["idle_gaps"])
    assert gaps[0.017] == "between rounds"        # 83 -> 100 ms
    assert gaps[0.007] == "stage"                 # 33 -> 40 ms
    assert gaps[0.009] == "stage"                 # 41 -> 50 ms
    assert gaps[0.010] == "engine"                # 70 -> 80 ms
    assert gaps[0.002] == "between rounds"        # 10 -> 12 ms
    assert len(b["idle_gaps"]) <= 10 and len(b["device_ops"]) <= 10
