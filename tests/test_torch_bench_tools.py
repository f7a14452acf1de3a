"""The port's ``kernels_bench`` and ``check_regression`` against the
reference's: the sparse-aggregate section's analytic cells equal the
reference's at the same K, d and fractions, and the regression gate gives
the reference's verdict and exit code on the same pairs of files."""
import copy
import json
import pathlib
import subprocess
import sys

import pytest

from benchmarks import kernels_bench as rkb
from repro_torch.benchmarks import check_regression as CR
from repro_torch.benchmarks import kernels_bench as KB

ROOT = pathlib.Path(__file__).resolve().parents[1]
ANALYTIC = ("topk_frac", "k", "flops_dense", "flops_sparse", "flops_ratio")


@pytest.fixture
def small(monkeypatch):
    """kernels_bench at small sizes: 4096-element sweeps, flash at L 64,
    the SSD at L 64 (chunk 32), KD 32 × 100, the sparse section at K 4 ×
    d 4096."""
    monkeypatch.setattr(KB, "N_SWEEP", 4096)
    monkeypatch.setattr(KB, "FLASH", (1, 2, 64, 16))
    monkeypatch.setattr(KB, "SSD", (1, 64, 2, 8, 8, 32))
    monkeypatch.setattr(KB, "KD_SHAPE", (32, 100))
    monkeypatch.setattr(KB, "SPARSE", {"K": 4, "d": 4096})
    monkeypatch.setattr(KB, "ITERS", 1)


def test_kernels_bench_on_the_cpu_writes_the_references_fields(
        small, tmp_path):
    out = tmp_path / "BENCH_kernels_torch.json"
    rows = KB.main([], device="cpu", out_json=str(out))
    names = [r.split(",")[0] for r in rows]
    assert names[:3] == ["kernel.fedadc_local_update.1M",
                         "kernel.fedadc_server_update.1M",
                         "kernel.weighted_delta_reduce.K8.1M"]
    assert [n.split(".")[1] for n in names[3:11]] == [
        "fused_axpy", "threshold_select", "qsgd", "sparse_reduce",
        "flash_attention", "ssd_scan", "kd_loss", "kd_loss_bwd"]
    assert all(r.endswith("route=plain-cpu") for r in rows)
    got = json.loads(out.read_text())
    ref = json.loads((ROOT / "BENCH_kernels.json").read_text())
    assert set(got) == set(ref)
    assert set(got["sparse_aggregate"]) == set(ref["sparse_aggregate"])
    for cell, rcell in zip(got["sparse_aggregate"]["cells"],
                           ref["sparse_aggregate"]["cells"]):
        assert set(cell) == set(rcell)
    # the derived bytes of the reference's rows
    n = KB.N_SWEEP
    assert f"bytes_moved={4 * n * 4};vs_unfused={6 * n * 4}" in rows[0]
    # every kernel of ops.KERNELS has a row, under the reference's names
    # where it has one
    from repro_torch.kernels import ops
    named = {"fedadc_local_update": "local_update",
             "fedadc_server_update": "server_update",
             "weighted_delta_reduce": "weighted_reduce"}
    kernels = {named.get(n.split(".")[1], n.split(".")[1])
               for n in names if "sparse_aggregate" not in n}
    assert kernels == set(ops.KERNELS)


def test_sparse_aggregate_cells_equal_the_references():
    K, d = 4, 4096
    got = KB.sparse_aggregate_section([], KB.resolve_device("cpu"), K=K,
                                      d=d)
    want = rkb.sparse_aggregate_section([], K=K, d=d)
    assert [{k: c[k] for k in ANALYTIC} for c in got["cells"]] == \
        [{k: c[k] for k in ANALYTIC} for c in want["cells"]]
    for key in ("K", "d", "flops_scale_with_k", "ge_4x_at_0p1"):
        assert got[key] == want[key]


def test_the_committed_bench_file_is_the_cpu_runs():
    """``BENCH_kernels_torch.json`` at the root (written by a CPU run)
    holds the reference's analytic cells at K 16, d 2^20."""
    got = json.loads((ROOT / "BENCH_kernels_torch.json").read_text())
    ref = json.loads((ROOT / "BENCH_kernels.json").read_text())
    for key in ("K", "d", "flops_scale_with_k", "ge_4x_at_0p1"):
        assert got["sparse_aggregate"][key] == ref["sparse_aggregate"][key]
    assert [{k: c[k] for k in ANALYTIC}
            for c in got["sparse_aggregate"]["cells"]] == \
        [{k: c[k] for k in ANALYTIC}
         for c in ref["sparse_aggregate"]["cells"]]


def _pairs(tmp_path):
    committed = json.loads((ROOT / "BENCH_kernels.json").read_text())
    ok = copy.deepcopy(committed)
    for c in ok["sparse_aggregate"]["cells"]:
        c["us_dense"] *= 3.0          # wall-clock keys are skipped
        c["speedup"] = 0.5
    off = copy.deepcopy(committed)
    off["sparse_aggregate"]["cells"][2]["flops_sparse"] *= 1.3
    missing = copy.deepcopy(committed)
    files = {}
    for name, body in (("committed", committed), ("ok", ok), ("off", off),
                       ("missing", missing)):
        files[name] = tmp_path / f"{name}.json"
        files[name].write_text(json.dumps(body))
    return files


@pytest.mark.parametrize("case,require", [
    ("ok", []), ("off", []), ("missing", ["sparse_aggregate.not_there"]),
    ("ok", ["sparse_aggregate"])])
def test_check_regression_gives_the_references_verdict(case, require,
                                                       tmp_path, capsys):
    files = _pairs(tmp_path)
    pair = f"{files[case]}:{files['committed']}"
    args = [pair] + (["--require", *require] if require else [])
    ref = subprocess.run([sys.executable, str(ROOT / "benchmarks" /
                                              "check_regression.py"), *args],
                         capture_output=True, text=True, timeout=120)
    code = CR.main(args)
    out = capsys.readouterr().out
    assert code == ref.returncode == (0 if case == "ok" else 1)
    assert out == ref.stdout
