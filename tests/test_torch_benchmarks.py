"""The port's benchmark drivers (``repro_torch.benchmarks``) against the
reference's (``benchmarks/`` at the repository root), on the CPU.

The paper figures train for hundreds of rounds, so their drivers are held
to the reference's without training: ``run_fl`` is replaced, in both
driver modules and at test time only, by a stub that records each call
(strategy, keywords, the partition arrays) and returns an accuracy hashed
from the call.  Equal call lists and equal emitted rows (names and
``derived`` strings) then mean the same experiment grid and the same
reporting.  What the stubs stand in for is held on its own: ``run_fl`` and
``run_fl_async`` against the reference's at two rounds / flushes from the
reference's init (the simulator parity tests' bars: parameters within
1e-3 of each leaf's scale over several rounds, 1e-5 over async flushes),
fig7's head calibration from the reference's CNN init (accuracies within
``test_torch_personalization.py``'s 0.02).  The byte counts of
``comm_load`` and the fleet bench's byte fields are exact.

Torch runs on one thread here: the drivers' tensors are tiny, and
oversubscribed threads make them many times slower.
"""
import dataclasses
import importlib
import importlib.util
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from _bench_stubs import digest, stub_comm  # noqa: E402
from benchmarks import common as rcommon  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402

FIGURES = ("fig1_acceleration", "fig2_robustness", "ablation_beta",
           "clustering", "table1_sota", "fig5_scale")
UNPORTED = ("roofline_report", "kernels_bench")
# ported with the telemetry slice; their drivers are held to the
# reference's in test_torch_comm_sweep.py
TELEMETRY_DRIVERS = ("comm_sweep", "telemetry_bench")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def modules(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.benchmarks.{name}"))


def names(rows):
    return [r.split(",")[0] for r in rows]


def stub_run_fl(calls, common, port):
    """A recording ``run_fl`` whose numbers are a hash of the call."""
    def run_fl(strategy, parts, data, **kw):
        if port:
            assert kw.pop("device") == "cpu"
        assert data is common.dataset()
        key = digest(strategy, sorted(kw.items()), *parts)
        calls.append((strategy, sorted(kw.items()), key))
        v = int(key[:12], 16)
        return {"acc": (v % 1000) / 1000, "loss": 1.0,
                "us_per_round": float(v % 99991),
                "hist": [{"acc": (v // 1000 % 1000) / 1000}], "sim": None}
    return run_fl


class StubEngine:
    """Stands in for ``AsyncFederatedSimulator``: records its configs and
    returns a history with the virtual clock the engine's would carry."""

    def __init__(self, record, fed, sim, hetero, x, y, xt, yt, parts, **kw):
        record.append((dataclasses.asdict(fed), dataclasses.asdict(sim),
                       dataclasses.asdict(hetero), digest(*parts),
                       sorted(kw.items())))
        self.sim = sim
        self.staleness_hist = SimpleNamespace(max=sim.rounds // 20)

    def run(self):
        e = self.sim.eval_every
        return [{"round": r, "t": 7.5 * r * (1 + self.sim.rounds % 7),
                 "acc": min(0.02 * r, 0.9)}
                for r in range(e, self.sim.rounds + 1, e)]


def stub_engines(monkeypatch, rmod, pmod):
    rec = {"ref": [], "port": []}
    monkeypatch.setattr(rmod, "AsyncFederatedSimulator",
                        lambda *a, **k: StubEngine(rec["ref"], *a, **k))
    monkeypatch.setattr(pmod, "AsyncFederatedSimulator",
                        lambda *a, **k: StubEngine(rec["port"], *a, **k))
    return rec


def stub_fleet_cell(fleet, hierarchical, rounds, seed=0, device=None):
    return {"fleet": fleet, "mode": "hier" if hierarchical else "flat",
            "peak_host_bytes": 5 if hierarchical else 7, "budget_ok": True,
            "spills_per_round": 1.0, "rounds_per_s": 2.0}


def stub_serving_level(params, prompts, n_slots, prefill_chunk=16,
                       device=None):
    lat = {k: {"p50": 0.1, "p95": 0.2} for k in ("e2e_s", "ttft_s", "itl_s")}
    return {"wall_s": 1.0, "gen_tokens": 10, "tokens_per_s": 10.0 * n_slots,
            "latency": lat}, []


def reference_rows(monkeypatch, tmp_path, ref_cnn, ref_comm_rows):
    """Every reference driver's row names, the training and engines
    stubbed (comm_load runs as it is: it only counts bytes)."""
    out = {}
    for name in FIGURES:
        rmod = importlib.import_module(f"benchmarks.{name}")
        monkeypatch.setattr(rmod, "run_fl", stub_run_fl([], rcommon, False))
        out[name] = names(rmod.main([]))
    rmod = importlib.import_module("benchmarks.fig7_personalization")
    monkeypatch.setattr(rmod, "run_fl", lambda *a, **k: {
        "sim": ref_cnn, "us_per_round": 1.0})
    monkeypatch.setattr(rmod, "calibrate_head", lambda p, *a, **k: p)
    out["fig7_personalization"] = names(rmod.main([]))
    rmod = importlib.import_module("benchmarks.straggler_bench")
    monkeypatch.setattr(rmod, "AsyncFederatedSimulator",
                        lambda *a, **k: StubEngine([], *a, **k))
    out["straggler_bench"] = names(rmod.main([]))
    rmod = importlib.import_module("benchmarks.fleet_bench")
    monkeypatch.setattr(rmod, "_run_mode", stub_fleet_cell)
    out["fleet_bench"] = names(rmod.main(
        [], out_json=str(tmp_path / "fleet.json")))
    rmod = importlib.import_module("benchmarks.serving_bench")
    monkeypatch.setattr(rmod, "run_level", stub_serving_level)
    out["serving_bench"] = names(rmod.main(
        [], out_json=str(tmp_path / "serving.json")))
    out["comm_load"] = names(ref_comm_rows)
    for name in TELEMETRY_DRIVERS:
        rmod = importlib.import_module(f"benchmarks.{name}")
        stub_comm(monkeypatch, rmod, rcommon, False)
        out[name] = names(rmod.main([], out_json=str(tmp_path / name)))
    return out


@pytest.fixture(scope="module")
def ref_comm_rows():
    return importlib.import_module("benchmarks.comm_load").main([])


@pytest.fixture(scope="module")
def ref_cnn():
    """The reference's CNN at the drivers' width 8 on 16x16 images, from
    PRNGKey(0), as a simulator-like object.  Init and forward are jitted,
    the forward on batches padded to the test set's size: op by op, JAX
    compiles each op anew for every client's test-set shape."""
    from repro.models.vision import cnn_apply, cnn_init
    params = jax.jit(lambda k: cnn_init(k, 10, width=8, image_size=16))(
        jax.random.PRNGKey(0))
    forward = jax.jit(cnn_apply)
    n_test = len(rcommon.dataset()[2])

    def apply(p, x):
        if isinstance(x, jax.core.Tracer):     # inside calibrate_head's jit
            return cnn_apply(p, x)
        pad = jnp.zeros((n_test - len(x),) + x.shape[1:], x.dtype)
        return forward(p, jnp.concatenate([x, pad]))[:len(x)]
    return SimpleNamespace(params=params, apply=apply)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
def test_dataset_matches_reference_bit_for_bit():
    for a, b in zip(rcommon.dataset(), pcommon.dataset()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert pcommon.dataset() is pcommon.dataset()        # cached


@pytest.mark.parametrize("n_clients,kind,param", [
    (20, "sort", 2), (20, "sort", 3), (20, "sort", 4), (20, "dir", 0.3),
    (20, "dir", 0.1), (50, "dir", 0.3)])
def test_partitions_match_reference_bit_for_bit(n_clients, kind, param):
    y = rcommon.dataset()[1]
    want = rcommon.partitions(y, n_clients, kind, param)
    got = pcommon.partitions(y, n_clients, kind, param)
    assert len(got) == len(want) == n_clients
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the figure drivers: the same grid of runs and the same rows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", FIGURES)
def test_figure_driver_matches_reference(monkeypatch, name):
    rmod, pmod = modules(name)
    calls = {"ref": [], "port": []}
    monkeypatch.setattr(rmod, "run_fl",
                        stub_run_fl(calls["ref"], rcommon, False))
    monkeypatch.setattr(pmod, "run_fl",
                        stub_run_fl(calls["port"], pcommon, True))
    want = rmod.main([])
    got = pmod.main([], device="cpu")
    assert calls["port"] == calls["ref"]
    assert len(calls["ref"]) >= 2
    assert got == want
    assert pmod.ROUNDS == rmod.ROUNDS


def stub_calibrate(calls, calibrate, steps, real_calls):
    """A recording ``calibrate_head``: its first ``real_calls`` calls run
    the real calibration for ``steps`` of the steps asked for, the rest
    return the global model unchanged."""
    def calibrate_head(params, apply_fn, head_key, x, y, counts, **kw):
        calls.append((head_key, digest(np.asarray(x), np.asarray(y),
                                       np.asarray(counts, np.float32)),
                      sorted(kw.items())))
        if len(calls) > real_calls:
            return params
        return calibrate(params, apply_fn, head_key, x, y, counts,
                         **dict(kw, steps=min(kw["steps"], steps)))
    return calibrate_head


def test_fig7_driver_matches_reference(monkeypatch, ref_cnn):
    """The stubbed run_fl hands both drivers the reference's CNN init (the
    port's converted), so the per-client accuracies run for real.  The
    calibrations are recorded (both drivers ask for the same 60 steps,
    batch, eta and regulariser per client); the first client's three run
    for real, for 10 of their steps, ``test_torch_personalization.py``'s
    length: from a random init the two trajectories part chaotically past
    ~30 steps (client 2, unregularised, 60 steps: heads 0.43 of their scale
    apart after agreeing to 1e-7 at step 1).  The reference compiles each
    calibration anew, so the rest keep the global head."""
    rmod, pmod = modules("fig7_personalization")
    from repro_torch.models.vision import cnn_apply
    ref_sim = ref_cnn
    port_sim = SimpleNamespace(
        params=convert.from_numpy(jax.tree.map(np.asarray, ref_sim.params),
                                  "cpu"),
        apply=cnn_apply, device=torch.device("cpu"))
    calls = {"ref": [], "port": []}
    calib = {"ref": [], "port": []}

    def stub(record, sim, common, port):
        inner = stub_run_fl(record, common, port)

        def run_fl(*a, **k):
            return dict(inner(*a, **k), sim=sim)
        return run_fl
    for side, mod, sim, common in (("ref", rmod, ref_sim, rcommon),
                                   ("port", pmod, port_sim, pcommon)):
        monkeypatch.setattr(mod, "run_fl", stub(calls[side], sim, common,
                                                side == "port"))
        monkeypatch.setattr(mod, "calibrate_head", stub_calibrate(
            calib[side], mod.calibrate_head, 10, 3))
    want = rmod.main([])
    got = pmod.main([], device="cpu")
    assert calls["port"] == calls["ref"] and len(calls["ref"]) == 1
    assert calib["port"] == calib["ref"] and len(calib["ref"]) == 30
    assert names(got) == names(want) and len(got) == 7
    for g, w in zip(got, want):
        g_us, g_val = g.split(",")[1:]
        w_us, w_val = w.split(",")[1:]
        assert g_us == w_us
        assert abs(float(g_val) - float(w_val)) <= 0.02, (g, w)


# ---------------------------------------------------------------------------
# run_fl and run_fl_async against the reference's, from the reference's init
# ---------------------------------------------------------------------------
def capture_init(monkeypatch, module, attr):
    """Wrap ``module.attr`` (an engine class) to keep a numpy copy of the
    first engine's initial parameters."""
    cls, seen = getattr(module, attr), []

    def make(*a, **k):
        eng = cls(*a, **k)
        seen.append(jax.tree.map(np.array, eng.params))
        return eng
    monkeypatch.setattr(module, attr, make)
    return seen


def with_params(monkeypatch, module, attr, params):
    cls = getattr(module, attr)
    monkeypatch.setattr(module, attr, lambda *a, **k: cls(
        *a, params=convert.from_numpy(params, "cpu"), **k))


def assert_params_close(got, want, tol):
    got = jax.tree.leaves(convert.to_numpy(got))
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        scale = np.abs(w).max() + 1e-12
        np.testing.assert_allclose(g / scale, w / scale, atol=tol, rtol=0)


def test_run_fl_matches_reference(monkeypatch):
    """Two FedADC rounds at seed 2 (where the simulator parity tests
    hold)."""
    strategy, kw = "fedadc", dict(eta=0.01)
    data = rcommon.dataset()
    parts = rcommon.partitions(data[1], 20, "sort", 2)
    init = capture_init(monkeypatch, rcommon, "FederatedSimulator")
    want = rcommon.run_fl(strategy, parts, data, rounds=2, seed=2, **kw)
    with_params(monkeypatch, pcommon, "FederatedSimulator", init[0])
    got = pcommon.run_fl(strategy, parts, pcommon.dataset(), rounds=2,
                         seed=2, device="cpu", **kw)
    assert set(got) == set(want)
    assert [h["round"] for h in got["hist"]] == [2]
    assert abs(got["acc"] - want["acc"]) <= 0.02
    assert abs(got["loss"] - want["loss"]) <= 1e-3 * abs(want["loss"])
    assert got["us_per_round"] > 0
    assert_params_close(got["sim"].params, want["sim"].params, 1e-3)


def test_run_fl_async_matches_reference(monkeypatch):
    """Two flushes of buffered-2 FedADC, two clients a wave, under the
    straggler bench's fleet at seed 2: the event log equal tuple for tuple,
    the parameters at the async parity tests' 1e-5 (staleness is
    ``test_torch_async.py``'s).  Seed 0 meets a branch point in its first
    flush (4 clients a wave: 4.5e-2 of a leaf's scale apart, where seeds
    1-3 stay within 2.3e-6)."""
    from repro.configs.base import HeteroConfig as JHetero
    from repro_torch.benchmarks.straggler_bench import STRAGGLERS
    hetero = STRAGGLERS
    data = rcommon.dataset()
    parts = rcommon.partitions(data[1], 20, "sort", 2)
    kw = dict(rounds=2, eta=0.01, clients_per_round=2, seed=2,
              extra_fed={"buffer_k": 2})
    init = capture_init(monkeypatch, rcommon, "AsyncFederatedSimulator")
    want = rcommon.run_fl_async("fedadc", parts, data,
                                hetero=JHetero(**dataclasses.asdict(hetero)),
                                **kw)
    with_params(monkeypatch, pcommon, "AsyncFederatedSimulator", init[0])
    got = pcommon.run_fl_async("fedadc", parts, pcommon.dataset(),
                               hetero=hetero, device="cpu", **kw)
    assert set(got) == set(want)
    assert list(got["sim"].event_log) == list(want["sim"].event_log)
    assert [(h["round"], h["t"]) for h in got["hist"]] == \
        [(h["round"], h["t"]) for h in want["hist"]]
    assert abs(got["acc"] - want["acc"]) <= 0.02
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=2e-4)
    assert_params_close(got["sim"].params, want["sim"].params, 1e-5)


# ---------------------------------------------------------------------------
# straggler, comm_load, fleet, serving
# ---------------------------------------------------------------------------
def test_straggler_bench_builds_the_reference_configs(monkeypatch):
    rmod, pmod = modules("straggler_bench")
    rec = stub_engines(monkeypatch, rmod, pmod)
    want = rmod.main([])
    got = pmod.main([], device="cpu")
    assert len(rec["ref"]) == 2
    port = [(f, s, h, p, [kv for kv in kw if kv[0] != "device"])
            for f, s, h, p, kw in rec["port"]]
    assert port == rec["ref"]
    assert all(dict(kw)["device"] == "cpu" for *_, kw in rec["port"])
    assert got == want
    assert dataclasses.asdict(pmod.STRAGGLERS) == \
        dataclasses.asdict(rmod.STRAGGLERS)


def test_comm_load_rows_equal_the_reference_character_for_character(
        ref_comm_rows):
    got = importlib.import_module("repro_torch.benchmarks.comm_load").main(
        [])
    want = ref_comm_rows
    assert len(want) == 62
    assert got == want


@pytest.mark.parametrize("hierarchical", [False, True])
def test_fleet_bench_cells_equal_the_reference(hierarchical):
    """FLEETS cut to (1000,), the smoke's two rounds: every field but the
    wall clock's."""
    rmod, pmod = modules("fleet_bench")
    want = rmod._run_mode(1000, hierarchical, 2)
    got = pmod._run_mode(1000, hierarchical, 2, device="cpu")
    assert got.pop("rounds_per_s") > 0
    want.pop("rounds_per_s")
    assert got == want


def test_serving_smoke_passes_with_the_committed_counters(tmp_path):
    """No stop rule but max_new_tokens ends a request, so the token and
    step counts depend only on the lengths and the scheduler."""
    import json
    pmod = importlib.import_module("repro_torch.benchmarks.serving_bench")
    report = pmod.smoke(out_json=str(tmp_path / "smoke.json"), device="cpu")
    committed = json.loads((ROOT / "BENCH_serving_smoke.json").read_text())
    assert report == committed
    assert json.loads((tmp_path / "smoke.json").read_text()) == committed


def test_serving_greedy_tokens_equal_the_reference_engine():
    """TINY's weights from the reference's PRNGKey(0) init, carried across:
    the 4-slot engine's greedy tokens equal the reference engine's, on the
    smoke's first four requests."""
    rmod, pmod = modules("serving_bench")
    from repro.models.registry import get_model
    jparams = get_model(rmod.TINY).init(jax.random.PRNGKey(0), rmod.TINY)
    params = convert.from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    prompts = pmod.make_requests(8)
    assert prompts == rmod.make_requests(8)
    prompts = prompts[:4]
    res_w, want = rmod.run_level(jax.tree.map(jnp.asarray, jparams),
                                 prompts, n_slots=4)
    res_g, got = pmod.run_level(params, prompts, n_slots=4, device="cpu")
    assert [o.tokens for o in got] == [o.tokens for o in want]
    for k in ("n_slots", "n_requests", "gen_tokens", "engine_steps"):
        assert res_g[k] == res_w[k], k
    assert dataclasses.asdict(pmod.TINY) == dataclasses.asdict(rmod.TINY)


# ---------------------------------------------------------------------------
# chip_smoke's BENCH_ROWS, the harness, the port's rules
# ---------------------------------------------------------------------------
def test_chip_smoke_bench_rows_are_the_reference_names(
        monkeypatch, tmp_path, ref_cnn, ref_comm_rows):
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    want = reference_rows(monkeypatch, tmp_path, ref_cnn, ref_comm_rows)
    assert chip_smoke.BENCH_ROWS == want
    run = importlib.import_module("repro_torch.benchmarks.run")
    assert set(chip_smoke.BENCH_ROWS) == set(run.MODULES)


@pytest.mark.parametrize("name", UNPORTED)
def test_run_only_an_unported_module_exits_non_zero(name, capsys):
    run = importlib.import_module("repro_torch.benchmarks.run")
    assert run.main(["--only", name, "--device", "cpu"]) != 0
    err = capsys.readouterr().err
    assert "not ported" in err and "Queue 1 item" in err
    assert name in run.__doc__ and name not in run.MODULES


@pytest.mark.parametrize("name", TELEMETRY_DRIVERS)
def test_run_only_a_telemetry_driver_runs_it(name, monkeypatch, tmp_path,
                                             capsys):
    """comm_sweep and telemetry_bench are run.py modules now: ``--only``
    takes them by name, and their rows print (the training stubbed)."""
    run = importlib.import_module("repro_torch.benchmarks.run")
    pmod = importlib.import_module(f"repro_torch.benchmarks.{name}")
    stub_comm(monkeypatch, pmod, pcommon, True)
    monkeypatch.chdir(tmp_path)
    assert name in run.MODULES and name not in run.UNPORTED
    assert name in run.__doc__.split("Not ported yet")[0]
    assert run.main(["--only", name, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"# {name} took" in out and "ERROR" not in out
    assert (tmp_path / f"BENCH_{name.split('_')[0]}_torch.json").exists()


def test_run_without_a_card_fails_instead_of_falling_back(monkeypatch):
    run = importlib.import_module("repro_torch.benchmarks.run")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run.main(["--only", "fig1_acceleration"])


def test_run_prints_a_driver_rows_on_the_cpu(monkeypatch, capsys):
    run = importlib.import_module("repro_torch.benchmarks.run")
    pmod = importlib.import_module("repro_torch.benchmarks.fig1_acceleration")
    monkeypatch.setattr(pmod, "run_fl", stub_run_fl([], pcommon, True))
    assert run.main(["--only", "fig1_acceleration", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    rows = [r for r in out if r.startswith("fig1.")]
    assert out[0] == "name,us_per_call,derived" and len(rows) == 12
    # a failing driver gives an ERROR row and a non-zero exit
    monkeypatch.setattr(pmod, "run_fl", None)
    assert run.main(["--only", "fig1_acceleration", "--device", "cpu"]) == 1
    assert "fig1_acceleration,0,ERROR:" in capsys.readouterr().out
