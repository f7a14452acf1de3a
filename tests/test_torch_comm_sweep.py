"""The port's engines with telemetry on, and its ``comm_sweep`` and
``telemetry_bench`` drivers, against the reference's, on the CPU.

*Engines.*  The synchronous simulator (plain FedADC, top-k 10% + EF on the
dense and on the sparse wire, FedDyn) and the semi-async engine (two
buffered-2 flushes under a straggler fleet) run from one converted init
(CNN width 8, 16x16 images, 6 clients, |S| 3, H 2, seed 2) in both
packages with telemetry on: the drift curves agree within rtol 1e-4, with
the same rounds and keys.  Telemetry disabled, or on, leaves the port's
parameters and losses bit for bit those of a run without ``telemetry=``.
On the CPU the wrappers call the kernels' plain versions, so the kernels'
launch counters do not move; a round's ATen calls are counted instead,
under a ``TorchDispatchMode``: a disabled round makes exactly the calls of
a run without telemetry, and an enabled round's extra calls stay under the
bound PERF.md states (4L + 40 on the dense wire, 12L + 40 on the sparse
wire, 16L + 40 for FedDyn, whose metrics need an aggregate its server step
skips; L = 16 leaves).

*Examples.*  ``--telemetry-jsonl`` on the quickstart, the async example
(their engines cut to two rounds of one step) and ``serve_demo --engine``
writes a schema-valid JSONL file.

*Drivers.*  ``run_fl`` / ``run_fl_async`` are stubbed in both driver
modules (``_bench_stubs.py``): the same call grid gives the same rows and
the same JSON.
"""
import dataclasses
import importlib
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _bench_stubs import stub_comm

from repro.configs.base import FedConfig as JFedConfig
from repro.configs.base import HeteroConfig as JHeteroConfig
from repro.data.partition import sort_and_partition
from repro.data.synthetic import make_image_dataset
from repro.federated.async_engine import AsyncFederatedSimulator as JAsync
from repro.federated.simulator import FederatedSimulator as JSim
from repro.federated.simulator import SimConfig as JSimConfig
from repro.telemetry import Telemetry as JTelemetry
from repro_torch import convert
from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.core import tree as T
from repro_torch.federated.async_engine import AsyncFederatedSimulator
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.telemetry import Telemetry, validate_jsonl

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmarks import common as rcommon  # noqa: E402
from repro_torch.benchmarks import common as pcommon  # noqa: E402

DRIFT_RTOL = 1e-4
# delta_dispersion's bar: the reference reduces in fp32 through XLA's CPU
# dot, whose sum of squares over this CNN's 131,072-element fc leaf is
# 2.3e-5 below the fp64 sum (numpy data, seed 0); the port's torch
# reductions stay within 1e-7 of it, and the port's update norm equals
# ||θ_t − θ_t+1|| (see test_update_norm_is_the_parameters_step).  The
# dispersion is a ratio of such sums, and the curves part by up to 1.5e-4
# over seeds 1-3 at this size.
DISPERSION_RTOL = 3e-4
N_LEAVES = 16
TOPK = dict(compressor="topk", topk_frac=0.1, error_feedback=True)
SYNC = {
    "plain": ("fedadc", {}),
    "topk_ef": ("fedadc", TOPK),
    "topk_ef_sparse": ("fedadc", dict(TOPK, sparse_uplink=True)),
    "feddyn": ("feddyn", {}),
}
# extra ATen calls an enabled round may make (PERF.md §5)
CALL_BOUND = {"plain": 4 * N_LEAVES + 40, "topk_ef": 4 * N_LEAVES + 40,
              "topk_ef_sparse": 12 * N_LEAVES + 40,
              "feddyn": 16 * N_LEAVES + 40}
HETERO = dict(enabled=True, speed_dist="bimodal", straggler_frac=0.25,
              straggler_slowdown=4.0, seed=0)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    x, y, xt, yt = make_image_dataset(600, 100, 10, image_size=16, seed=0,
                                      noise=0.5)
    return x, y, xt, yt, sort_and_partition(y, 6, s=2, seed=0)


def fed_kw(strategy, extra, **kw):
    base = dict(strategy=strategy, local_steps=2, clients_per_round=3,
                n_clients=6, eta=0.03, beta_global=0.6, beta_local=0.6)
    base.update(extra, **kw)
    return base


def sim_kw(rounds=2):
    return dict(model="cnn", n_classes=10, batch_size=16, rounds=rounds,
                eval_every=rounds, cnn_width=8, seed=2)


def port_sim(data, fed, params, telemetry="none", rounds=2, engine=None,
             hetero=None):
    """The port's engine from the converted init; ``telemetry`` "none"
    (no argument), "off" (disabled) or a Telemetry."""
    x, y, xt, yt, parts = data
    kw = {} if telemetry == "none" else {
        "telemetry": Telemetry.disabled() if telemetry == "off"
        else telemetry}
    if hetero is not None:
        return AsyncFederatedSimulator(
            FedConfig(**fed), SimConfig(**sim_kw(rounds)),
            HeteroConfig(**hetero), x, y, xt, yt, parts,
            params=convert.from_numpy(params, "cpu"), device="cpu", **kw)
    return FederatedSimulator(FedConfig(**fed), SimConfig(**sim_kw(rounds)),
                              x, y, xt, yt, parts,
                              params=convert.from_numpy(params, "cpu"),
                              device="cpu", **kw)


def run_both(data, fed, hetero=None):
    """The reference and the port, both with telemetry on, from the
    reference's init -> (ref, ref telemetry, port, port telemetry, init)."""
    x, y, xt, yt, parts = data
    jtel = JTelemetry(engine="ref")
    if hetero is None:
        ref = JSim(JFedConfig(**fed), JSimConfig(**sim_kw()), x, y, xt, yt,
                   parts, telemetry=jtel)
    else:
        ref = JAsync(JFedConfig(**fed), JSimConfig(**sim_kw()),
                     JHeteroConfig(**hetero), x, y, xt, yt, parts,
                     telemetry=jtel)
    init = jax.tree.map(np.asarray, ref.params)
    ptel = Telemetry(engine="port")
    port = port_sim(data, fed, init, ptel, hetero=hetero)
    ref.run()
    port.run()
    return ref, jtel, port, ptel, init


@pytest.fixture(scope="module")
def sync_runs(data):
    return {name: run_both(data, fed_kw(strategy, extra))
            for name, (strategy, extra) in SYNC.items()}


@pytest.fixture(scope="module")
def async_run(data):
    return run_both(data, fed_kw("fedadc", {}, buffer_k=2), hetero=HETERO)


def assert_curves_close(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["round"] == w["round"]
        for k in w:
            rtol = DISPERSION_RTOL if k == "delta_dispersion" else DRIFT_RTOL
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)


# ---------------------------------------------------------------------------
# the engines' drift curves against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", list(SYNC))
def test_sync_drift_curve_matches_reference(sync_runs, name):
    ref, jtel, port, ptel, _ = sync_runs[name]
    assert_curves_close(ptel.drift_curve, jtel.drift_curve)
    keys = set(ptel.drift_curve[-1])
    assert ("ef_residual_norm" in keys) == name.startswith("topk")
    assert ("momentum_alignment" in keys) == (name != "feddyn")
    assert ptel.tracer.summary()["round"]["count"] == 2
    assert ptel.counters.get("rounds") == 2
    # one transfer a round carried the loss with the metrics
    np.testing.assert_allclose(ptel.drift_curve[-1]["loss"],
                               port.history[-1]["loss"], rtol=0)


def test_update_norm_is_the_parameters_step(data, sync_runs):
    """FedAvg's server step is θ' = θ − Δ̄: the port's update_norm of its
    first round equals ||θ_0 − θ_1|| in fp64 (each leaf rounded once
    apiece) within 1e-6."""
    init = sync_runs["plain"][4]
    tel = Telemetry()
    sim = port_sim(data, fed_kw("fedavg", {}), init, tel, rounds=1)
    sim.run()
    step = np.sqrt(sum(
        np.sum((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
        for a, b in zip(jax.tree.leaves(init),
                        jax.tree.leaves(convert.to_numpy(sim.params)))))
    np.testing.assert_allclose(tel.drift_curve[0]["update_norm"], step,
                               rtol=1e-6)


def test_async_drift_curve_matches_reference(async_run):
    ref, jtel, port, ptel, _ = async_run
    assert list(port.event_log) == list(ref.event_log)
    assert_curves_close(ptel.drift_curve, jtel.drift_curve)
    assert [d["round"] for d in ptel.drift_curve] == [1, 2]
    spans = ptel.tracer.summary()
    assert spans["aggregate"]["count"] == 2
    assert spans["transport.encode"]["count"] == len(
        {v for kind, _, _, v in port.event_log if kind == "dispatch"})
    assert spans["local_train"]["count"] >= 2


def test_flush_staleness_is_what_the_event_log_gives(async_run):
    """Each flush's staleness_mean/max: the buffered arrivals' versions
    against the version the flush updates."""
    _, _, port, ptel, _ = async_run
    version, buffer, want = 0, [], []
    for kind, _, _, v in port.event_log:
        if kind == "arrive":
            buffer.append(version - v)
        elif kind == "update":
            want.append((float(np.mean(buffer)), float(max(buffer))))
            version, buffer = v, []
    got = [(d["staleness_mean"], d["staleness_max"])
           for d in ptel.drift_curve]
    assert got == want


# ---------------------------------------------------------------------------
# disabled and enabled runs give the bits of a run without telemetry
# ---------------------------------------------------------------------------
def assert_same_bits(a, b):
    for x, y in zip(T.leaves(a.params), T.leaves(b.params)):
        assert torch.equal(x, y)
    assert [h["loss"] for h in a.history] == [h["loss"] for h in b.history]
    assert [h["acc"] for h in a.history] == [h["acc"] for h in b.history]


@pytest.mark.parametrize("name", list(SYNC) + ["async"])
def test_telemetry_leaves_the_bits_alone(data, sync_runs, async_run, name):
    if name == "async":
        fed, hetero, run = fed_kw("fedadc", {}, buffer_k=2), HETERO, async_run
    else:
        fed, hetero, run = fed_kw(*SYNC[name]), None, sync_runs[name]
    enabled, init = run[2], run[4]
    bare = port_sim(data, fed, init, "none", hetero=hetero)
    off = port_sim(data, fed, init, "off", hetero=hetero)
    bare.run()
    off.run()
    assert_same_bits(off, bare)
    assert_same_bits(enabled, bare)
    assert list(off.telemetry.drift_curve) == []
    assert off.telemetry.tracer.summary() == {}


class CountCalls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def round_calls(data, fed, init, telemetry):
    """ATen calls of a simulator's second round."""
    sim = port_sim(data, fed, init, telemetry)
    sim.run_round(*sim.next_round_inputs())
    inputs = sim.next_round_inputs()
    with CountCalls() as c:
        sim.run_round(*inputs)
    return c.n


@pytest.mark.parametrize("name", list(SYNC))
def test_enabled_round_calls_stay_under_the_bound(data, sync_runs, name):
    fed, init = fed_kw(*SYNC[name]), sync_runs[name][4]
    bare = round_calls(data, fed, init, "none")
    assert round_calls(data, fed, init, "off") == bare
    extra = round_calls(data, fed, init, Telemetry()) - bare
    assert 0 < extra <= CALL_BOUND[name], extra


# ---------------------------------------------------------------------------
# the examples' --telemetry-jsonl
# ---------------------------------------------------------------------------
def shrunk(cls, rounds):
    """An engine class whose runs take one local step of batch 8 for
    ``rounds`` rounds (the examples' configurations take minutes here)."""
    def make(fed, sim, *a, **k):
        fed = dataclasses.replace(fed, local_steps=1)
        sim = dataclasses.replace(sim, rounds=rounds, eval_every=rounds,
                                  batch_size=8)
        return cls(fed, sim, *a, **k)
    return make


@pytest.mark.parametrize("example", ["quickstart", "async_straggler_example"])
def test_example_telemetry_flag_writes_schema_valid_jsonl(
        monkeypatch, tmp_path, example):
    mod = importlib.import_module(f"repro_torch.{example}")
    if example == "quickstart":
        monkeypatch.setattr(mod, "FederatedSimulator",
                            shrunk(FederatedSimulator, 2))
    else:
        monkeypatch.setattr(mod, "AsyncFederatedSimulator",
                            shrunk(AsyncFederatedSimulator, 2))
    path = tmp_path / "events.jsonl"
    mod.main(["--device", "cpu", "--telemetry-jsonl", str(path)])
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert validate_jsonl(str(path)) == len(events)
    kinds = [e["kind"] for e in events]
    assert kinds.count("summary") == 2 and kinds.count("round") == 4
    assert kinds.count("eval") == 2


def test_serve_demo_telemetry_flag_records_each_request(tmp_path, capsys):
    """``serve_demo --engine --telemetry-jsonl``: a request event per
    request, the tokens counted, one summary; without ``--engine`` the
    flag is refused, as in the reference."""
    from repro_torch import serve_demo
    path = tmp_path / "serve.jsonl"
    outs = serve_demo.main(["--device", "cpu", "--engine", "--batch", "2",
                            "--prompt-len", "8", "--gen", "3",
                            "--telemetry-jsonl", str(path)])
    events = [json.loads(line) for line in path.read_text().splitlines()]
    assert validate_jsonl(str(path)) == len(events) == 5
    assert [e["kind"] for e in events].count("request") == len(outs) == 4
    summary = events[-1]
    assert summary["kind"] == "summary" and summary["engine"] == "serving"
    c = summary["counters"]
    assert c["serving.tokens_generated"] == sum(len(o.tokens) for o in outs)
    assert c["serving.queue_depth"] == c["serving.slots_occupied"] == 0
    assert c["serving.steps"] >= 3 and summary["latency"]["n_requests"] == 4
    with pytest.raises(SystemExit):
        serve_demo.main(["--device", "cpu", "--telemetry-jsonl",
                         str(tmp_path / "x.jsonl")])
    assert "--engine" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the drivers: the same calls, rows and JSON as the reference's
# ---------------------------------------------------------------------------
def drivers(name):
    return (importlib.import_module(f"benchmarks.{name}"),
            importlib.import_module(f"repro_torch.benchmarks.{name}"))


def test_comm_sweep_grid_rows_and_json_equal_the_reference(monkeypatch,
                                                           tmp_path):
    rmod, pmod = drivers("comm_sweep")
    for const in ("STRATEGIES", "COMPRESSORS", "ASYNC_KNOBS",
                  "ASYNC_STALENESS", "DOWNLINK_KNOBS", "INTERMITTENT_GRID"):
        assert getattr(pmod, const) == getattr(rmod, const), const
    assert dataclasses.asdict(pmod.ASYNC_HETERO) == \
        dataclasses.asdict(rmod.ASYNC_HETERO)
    rstub = stub_comm(monkeypatch, rmod, rcommon, False)
    pstub = stub_comm(monkeypatch, pmod, pcommon, True)
    want = rmod.main([], out_json=str(tmp_path / "ref.json"))
    got = pmod.main([], out_json=str(tmp_path / "port.json"), device="cpu")
    assert pstub.calls == rstub.calls
    assert len(rstub.calls) == 9 + 8 + 4 + 3
    assert [c[-1] for c in rstub.calls] == [True] * 17 + [False] * 7
    assert got == want and len(got) == 29
    ref_json = json.loads((tmp_path / "ref.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == ref_json
    committed = json.loads((ROOT / "BENCH_comm.json").read_text())
    assert sorted(ref_json) == sorted(committed)
    assert sorted(ref_json["headline"]) == sorted(committed["headline"])
    assert sorted(ref_json["drift"]) == sorted(committed["drift"])


def test_comm_sweep_defaults_equal_the_reference():
    import inspect
    rmod, pmod = drivers("comm_sweep")
    for fn in ("sweep", "downlink_sweep", "async_sweep",
               "intermittent_sweep", "main"):
        want = dict(inspect.signature(getattr(rmod, fn)).parameters)
        got = dict(inspect.signature(getattr(pmod, fn)).parameters)
        assert got.pop("device").default is None
        if fn == "main":
            assert got.pop("out_json").default == "BENCH_comm_torch.json"
            want.pop("out_json")
        assert {k: p.default for k, p in got.items()} == \
            {k: p.default for k, p in want.items()}, fn


def test_drift_cell_equals_the_reference():
    """Each package's ``_drift_cell`` over the same recorded curve, a
    metric missing at the first round included."""
    rmod, pmod = drivers("comm_sweep")
    cells = []
    for mod, tel in ((rmod, JTelemetry()), (pmod, Telemetry())):
        tel.record_round(0, {"update_norm": 0.123456789, "loss": 2.5})
        tel.record_round(1, {"update_norm": 0.5, "loss": 2.25,
                             "delta_dispersion": 1.000004})
        tel.record_round(2, {"update_norm": 0.25, "loss": 2.0,
                             "delta_dispersion": 0.7654321})
        cells.append(mod._drift_cell(tel))
    assert cells[0] == cells[1]
    assert cells[0]["rounds_recorded"] == 3
    assert cells[0]["delta_dispersion_first"] == 0.76543


def test_telemetry_bench_rows_and_json_equal_the_reference(monkeypatch,
                                                           tmp_path):
    rmod, pmod = drivers("telemetry_bench")
    assert pmod.MAX_OVERHEAD == rmod.MAX_OVERHEAD == 0.05
    rstub = stub_comm(monkeypatch, rmod, rcommon, False)
    pstub = stub_comm(monkeypatch, pmod, pcommon, True)
    want = rmod.main([], out_json=str(tmp_path / "ref.json"))
    got = pmod.main([], out_json=str(tmp_path / "port.json"), device="cpu")
    assert pstub.calls == rstub.calls
    assert [(c[2][1], c[-1]) for c in rstub.calls] == [
        (("rounds", 4), False), (("rounds", 40), False),
        (("rounds", 4), True), (("rounds", 40), True)]
    assert got == want
    assert [r.split(",")[0] for r in got] == [
        "telemetry.sync_round_overhead", "telemetry.enabled_acc_identical"]
    ref_json = json.loads((tmp_path / "ref.json").read_text())
    assert json.loads((tmp_path / "port.json").read_text()) == ref_json
    assert sorted(ref_json) == sorted(
        json.loads((ROOT / "BENCH_telemetry.json").read_text()))
