"""The port's telemetry (``repro_torch.telemetry``) against the reference's
(``repro.telemetry``), on the CPU.

The drift diagnostics run on the same numpy arrays in both packages, dense
trees and stacked SparseLeaf wires, within rtol 1e-5 (both reduce in
fp32, in another order).  The host-side pieces — tracer, counters,
histograms, the schema, the JSONL sink, the Prometheus text and the
facade — are held to the reference's behaviour and output: each package's
JSONL validates under the other's schema, and ``prometheus_text`` is equal
character for character.
"""
import io
import json
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import telemetry as jtel
from repro.federated.compression import SparseLeaf as JSparseLeaf
from repro_torch import telemetry as ptel
from repro_torch.federated.compression import SparseLeaf
from repro_torch.telemetry import drift, schema, tracer

RTOL = 1e-5
SHAPES = {"c1": {"w": (3, 3, 3, 4), "b": (4,)}, "fc": {"w": (36, 10),
                                                         "b": (10,)}}


def tree_of(rng, lead=()):
    return {k: {n: rng.randn(*(lead + s)).astype(np.float32)
                for n, s in v.items()} for k, v in SHAPES.items()}


def to_jax(t):
    return {k: to_jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in t.items()}


def to_torch(t):
    return {k: to_torch(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in t.items()}


@pytest.fixture(scope="module")
def trees():
    """Five clients' deltas (around a common direction, so the dispersion
    is O(1)), their mean, a momentum, EF residuals."""
    rng = np.random.RandomState(0)
    base = tree_of(rng)
    noise = tree_of(rng, (5,))
    deltas = {k: {n: base[k][n] + 0.7 * noise[k][n] for n in v}
              for k, v in base.items()}
    mean = {k: {n: d.mean(0) for n, d in v.items()}
            for k, v in deltas.items()}
    return {"deltas": deltas, "mean": mean, "momentum": tree_of(rng),
            "efs": tree_of(rng, (5,))}


def wires(deltas, k=6, seed=1):
    """The top-k (value, index) wire of each client row, both packages'."""
    rng = np.random.RandomState(seed)
    jw, pw = {}, {}
    for name, leaves in deltas.items():
        jw[name], pw[name] = {}, {}
        for n, d in leaves.items():
            flat = d.reshape(d.shape[0], -1)
            kk = min(k, flat.shape[1])
            idx = np.stack([rng.permutation(flat.shape[1])[:kk]
                            for _ in range(flat.shape[0])]).astype(np.int32)
            vals = np.take_along_axis(flat, idx, 1)
            jw[name][n] = JSparseLeaf(jnp.asarray(vals), jnp.asarray(idx))
            pw[name][n] = SparseLeaf(torch.from_numpy(vals),
                                     torch.from_numpy(idx))
    return jw, pw


def close(got, want, rtol=RTOL):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), rtol=rtol)


# ---------------------------------------------------------------------------
# the drift diagnostics against the reference's
# ---------------------------------------------------------------------------
def test_delta_dispersion_dense(trees):
    close(drift.delta_dispersion(to_torch(trees["deltas"]),
                                 to_torch(trees["mean"])),
          jtel.delta_dispersion(to_jax(trees["deltas"]),
                                to_jax(trees["mean"])))


def test_delta_dispersion_sparse_wire(trees):
    """The wire's own dispersion (against the dense mean of the deltas):
    read off the wire in both packages, clamped at 0."""
    jw, pw = wires(trees["deltas"])
    want = jtel.delta_dispersion(jw, to_jax(trees["mean"]))
    close(drift.delta_dispersion(pw, to_torch(trees["mean"])), want)
    close(drift.sparse_delta_dispersion(pw, to_torch(trees["mean"])), want)


def test_sparse_dispersion_clamps_at_zero():
    """One client whose wire is exactly the mean: the identity gives
    ||Δ||² − 2⟨Δ, Δ̄⟩ + ||Δ̄||², epsilon-negative in fp32, clamped."""
    v = np.asarray([[0.1, 0.2, 0.3]], np.float32)
    i = np.asarray([[0, 2, 4]], np.int32)
    mean = np.zeros(5, np.float32)
    mean[[0, 2, 4]] = v[0]
    got = drift.delta_dispersion(
        {"w": SparseLeaf(torch.from_numpy(v), torch.from_numpy(i))},
        {"w": torch.from_numpy(mean)})
    want = jtel.delta_dispersion(
        {"w": JSparseLeaf(jnp.asarray(v), jnp.asarray(i))},
        {"w": jnp.asarray(mean)})
    assert float(got) >= 0.0 and float(want) >= 0.0
    np.testing.assert_allclose(float(got), float(want), atol=1e-6)


@pytest.mark.parametrize("which", ["momentum", "zero"])
def test_momentum_alignment(trees, which):
    m = trees["momentum"] if which == "momentum" else \
        {k: {n: np.zeros_like(x) for n, x in v.items()}
         for k, v in trees["momentum"].items()}
    got = drift.momentum_alignment(to_torch(m), to_torch(trees["mean"]))
    want = jtel.momentum_alignment(to_jax(m), to_jax(trees["mean"]))
    close(got, want)
    if which == "zero":
        assert float(got) == 0.0


def test_ef_residual_norm_and_update_norm(trees):
    close(drift.ef_residual_norm(to_torch(trees["efs"])),
          jtel.ef_residual_norm(to_jax(trees["efs"])))
    close(drift.update_norm(to_torch(trees["mean"])),
          jtel.update_norm(to_jax(trees["mean"])))


@pytest.mark.parametrize("momentum,efs", [(False, False), (True, False),
                                          (False, True), (True, True)])
@pytest.mark.parametrize("sparse", [False, True])
def test_round_metrics(trees, momentum, efs, sparse):
    """Keys depend only on which of momentum / EF is given; values match."""
    jd, pd = to_jax(trees["deltas"]), to_torch(trees["deltas"])
    if sparse:
        jd, pd = wires(trees["deltas"])
    kw_j = dict(momentum=to_jax(trees["momentum"]) if momentum else None,
                efs=to_jax(trees["efs"]) if efs else None)
    kw_p = dict(momentum=to_torch(trees["momentum"]) if momentum else None,
                efs=to_torch(trees["efs"]) if efs else None)
    want = jtel.round_metrics(jd, to_jax(trees["mean"]), **kw_j)
    got = ptel.round_metrics(pd, to_torch(trees["mean"]), **kw_p)
    assert list(got) == list(want)
    for k in want:
        close(got[k], want[k])


@pytest.mark.parametrize("sparse", [False, True])
def test_streaming_pair(trees, sparse):
    """Σ w_i·||Δ_i||² one client at a time, then the weighted dispersion,
    against the reference's; under uniform weights it is the stacked
    dispersion."""
    deltas, mean = trees["deltas"], trees["mean"]
    weights = [0.5, 1.0, 2.0, 1.5, 1.0]
    if sparse:
        jw, pw = wires(deltas)
    s_j, s_p = jnp.float32(0.0), torch.tensor(0.0)
    for i, w in enumerate(weights):
        if sparse:
            jrow = {k: {n: JSparseLeaf(x.values[i], x.indices[i])
                        for n, x in v.items()} for k, v in jw.items()}
            prow = {k: {n: SparseLeaf(x.values[i], x.indices[i])
                        for n, x in v.items()} for k, v in pw.items()}
        else:
            rows = {k: {n: d[i] for n, d in v.items()}
                    for k, v in deltas.items()}
            jrow, prow = to_jax(rows), to_torch(rows)
        part_j = jtel.streaming_sq_norm(jrow, jnp.float32(w))
        part_p = ptel.streaming_sq_norm(prow, torch.tensor(w))
        close(part_p, part_j)
        s_j, s_p = s_j + part_j, s_p + part_p
    total = float(sum(weights))
    close(ptel.streaming_dispersion(s_p, torch.tensor(total),
                                    to_torch(mean)),
          jtel.streaming_dispersion(s_j, jnp.float32(total), to_jax(mean)))
    if not sparse:
        # uniform weights: the stacked form
        s = sum(ptel.streaming_sq_norm(
            to_torch({k: {n: d[i] for n, d in v.items()}
                      for k, v in deltas.items()}), torch.tensor(1.0))
            for i in range(5))
        np.testing.assert_allclose(
            float(ptel.streaming_dispersion(s, torch.tensor(5.0),
                                            to_torch(mean))),
            float(drift.delta_dispersion(to_torch(deltas), to_torch(mean))),
            rtol=1e-4)


def test_drift_eps_and_exports():
    assert drift.EPS == jtel.drift.EPS == 1e-12
    assert ptel.__all__ == jtel.__all__
    for name in ptel.__all__:
        assert getattr(ptel, name) is not None


# ---------------------------------------------------------------------------
# tracer, counters, histogram
# ---------------------------------------------------------------------------
def test_tracer_nests_names_and_counts():
    for mod in (ptel, jtel):
        tr = mod.Tracer()
        with tr.span("round"):
            with tr.span("aggregate"):
                pass
            with tr.span("aggregate"):
                pass
        with tr.span("round"):
            pass
        s = tr.summary()
        assert sorted(s) == ["round", "round/aggregate"]
        assert s["round"]["count"] == 2 and s["round/aggregate"]["count"] == 2
        assert sorted(s["round"]) == ["count", "p50_s", "p95_s", "total_s"]
        assert len(tr.timings("round")) == 2 and tr.timings("none") == []


def test_tracer_reservoir_is_bounded_with_exact_count():
    tr = ptel.Tracer(maxlen=8)
    for _ in range(20):
        with tr.span("x"):
            pass
    assert len(tr.timings("x")) == 8
    assert tr.summary()["x"]["count"] == 20


def test_tracer_summary_percentiles_match_the_reference():
    durs = [0.5, 0.1, 0.3, 0.9, 0.2, 0.7, 0.4]
    out = []
    for mod in (ptel, jtel):
        tr = mod.Tracer()
        for d in durs:
            tr._record("x", d)
        out.append(tr.summary())
    assert out[0] == out[1]


def test_disabled_tracer_is_a_shared_no_op(monkeypatch):
    tr = ptel.Tracer(enabled=False)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: pytest.fail("synchronized"))
    a, b = tr.span("x", sync=torch.ones(2)), tr.span("y")
    assert a is b is tracer._NULL_SPAN
    with a:
        pass
    assert tr.summary() == {}


def test_span_waits_once_per_cuda_device_and_never_for_the_cpu(monkeypatch):
    """The span calls torch.cuda.synchronize once for each CUDA device
    among the tensors it was given (dicts, tuples and SparseLeaf wires
    walked), after the phase and before its clock stops; CPU tensors touch
    no torch.cuda state."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", calls.append)
    tr = ptel.Tracer()
    with tr.span("cpu") as sp:
        sp.sync = ({"w": torch.ones(3)}, SparseLeaf(torch.ones(2),
                                                    torch.zeros(2)))
    assert calls == []

    def card(i):   # stands in for a CUDA tensor: is_cuda and a device
        return SimpleNamespace(is_cuda=True, device=f"cuda:{i}")
    with tr.span("card") as sp:
        sp.sync = {"a": card(0), "b": [card(0), (card(1), torch.ones(1))]}
        assert calls == []
    assert sorted(calls) == ["cuda:0", "cuda:1"]
    assert tr.summary()["card"]["count"] == 1


def test_counters_and_histogram_match_the_reference():
    for mod in (ptel, jtel):
        c = mod.Counters()
        c.inc("a")
        c.inc("a", 2)
        c.set("g", 7)
        assert c.get("a") == 3 and c.get("missing") == 0 and "g" in c
        h = mod.Histogram(4)
        h.observe_many([0, 1, 1, 3, 9])
        assert h.to_dict() == {"bins": [1, 2, 0, 1], "overflow": 1,
                               "count": 5, "mean": 2.8, "max": 9}
        with pytest.raises(ValueError):
            h.observe(-1)
        h.reset()
        assert h.to_dict()["count"] == 0


# ---------------------------------------------------------------------------
# schema, sink, Prometheus text
# ---------------------------------------------------------------------------
GOOD = [
    {"ts": 1.0, "kind": "round", "engine": "sim", "round": 0,
     "metrics": {"delta_dispersion": 0.5, "loss": 2}},
    {"ts": 2, "kind": "eval", "engine": "sim", "round": 5, "acc": 0.5,
     "loss": 1.25, "extra": "ok"},
    {"ts": 3.0, "kind": "request", "engine": "serving", "rid": 1,
     "n_tokens": 1, "ttft_s": 0.1, "itl_s": None, "e2e_s": 0.2},
    {"ts": 4.0, "kind": "summary", "engine": "", "counters": {"a": 1}},
    {"ts": 5.0, "kind": "finding", "engine": "lint", "rule": "r",
     "path": "p.py", "line": 3, "message": "m"},
]
BAD = [
    [],
    {"kind": "eval", "engine": "sim", "round": 1, "acc": 0.5, "loss": 1.0},
    {"ts": True, "kind": "eval", "engine": "sim", "round": 1, "acc": 0.5,
     "loss": 1.0},
    {"ts": 1.0, "kind": "bogus", "engine": "sim"},
    {"ts": 1.0, "kind": "eval", "engine": "sim", "round": 1, "acc": 0.5},
    {"ts": 1.0, "kind": "eval", "engine": "sim", "round": 1, "acc": True,
     "loss": 1.0},
    {"ts": 1.0, "kind": "round", "engine": "sim", "round": 1.0,
     "metrics": {}},
    {"ts": 1.0, "kind": "round", "engine": "sim", "round": 1,
     "metrics": {"x": False}},
    {"ts": 1.0, "kind": "request", "engine": "s", "rid": 1, "n_tokens": 1,
     "ttft_s": 0.1, "itl_s": "no", "e2e_s": 0.2},
]


def test_schema_accepts_and_rejects_as_the_reference():
    assert schema.EVENT_SCHEMA == jtel.EVENT_SCHEMA
    for ev in GOOD:
        ptel.validate_event(ev)
        jtel.validate_event(ev)
    for ev in BAD:
        with pytest.raises(ValueError):
            ptel.validate_event(ev)
        with pytest.raises(ValueError):
            jtel.validate_event(ev)


def test_schema_entry_point_exit_codes(tmp_path, capsys):
    good, bad, empty = (tmp_path / n for n in ("g.jsonl", "b.jsonl",
                                               "e.jsonl"))
    good.write_text("".join(json.dumps(e) + "\n" for e in GOOD))
    bad.write_text(json.dumps(GOOD[0]) + "\nnot json\n")
    empty.write_text("\n")
    assert schema.main([str(good)]) == 0
    assert "OK" in capsys.readouterr().out
    assert schema.main([str(good), str(bad)]) == 1
    assert schema.main([str(empty)]) == 1
    assert schema.main([str(tmp_path / "missing.jsonl")]) == 1
    assert schema.main([]) == 2
    assert schema.validate_jsonl(str(good)) == len(GOOD)


def test_sink_owns_a_path_and_borrows_a_file(tmp_path):
    path = tmp_path / "e.jsonl"
    with ptel.JsonlSink(str(path)) as sink:
        sink.emit(GOOD[1])
        assert sink.n_events == 1
    assert sink._f.closed
    assert json.loads(path.read_text()) == GOOD[1]
    buf = io.StringIO()
    sink = ptel.JsonlSink(buf)
    sink.emit(GOOD[0])
    sink.close()
    assert not buf.closed
    assert buf.getvalue() == json.dumps(GOOD[0], sort_keys=True) + "\n"
    with pytest.raises(ValueError):
        sink.emit(BAD[3])


def telemetry_stream(mod, target):
    """The same event stream through either package's facade."""
    tel = mod.Telemetry(jsonl=target, engine="sim")
    tel.record_round(0, {"delta_dispersion": np.float32(0.25), "loss": 2.0})
    tel.record_round(1, {"delta_dispersion": 0.125, "loss": 1.5})
    tel.record_eval({"round": 2, "acc": 0.5, "loss": 1.5})
    out = SimpleNamespace(rid=3, tokens=[1, 2, 3], arrival_t=0.0,
                          first_token_t=0.5, finish_t=1.5)
    tel.record_request(out)
    tel.counters.inc("transport.uplink_bytes", 4096)
    tel.histogram("staleness", 4).observe_many([0, 1, 5])
    with tel.tracer.span("round"):
        pass
    summary = tel.emit_summary([out])
    tel.close()
    return tel, summary


def test_each_package_jsonl_validates_under_the_other(tmp_path):
    for mine, other in ((ptel, jtel), (jtel, ptel)):
        path = tmp_path / f"{mine.__name__}.jsonl"
        telemetry_stream(mine, str(path))
        assert other.validate_jsonl(str(path)) == 5
        assert mine.validate_jsonl(str(path)) == 5


def test_facade_records_and_summarises_as_the_reference(tmp_path):
    got, gs = telemetry_stream(ptel, str(tmp_path / "p.jsonl"))
    want, ws = telemetry_stream(jtel, str(tmp_path / "j.jsonl"))
    assert list(got.drift_curve) == list(want.drift_curve)
    assert list(got.history) == list(want.history)
    assert sorted(gs) == sorted(ws)
    for k in ("engine", "counters", "histograms", "drift", "latency"):
        assert gs[k] == ws[k], k
    assert sorted(gs["spans"]) == sorted(ws["spans"]) == ["round"]
    lines = [json.loads(x) for x in
             (tmp_path / "p.jsonl").read_text().splitlines()]
    assert [e["kind"] for e in lines] == ["round", "round", "eval",
                                          "request", "summary"]
    assert got.counters.get("rounds") == 2


def test_prometheus_text_equals_the_reference_character_for_character():
    texts = []
    for mod in (ptel, jtel):
        c = mod.Counters()
        c.inc("transport.uplink_bytes", 123456)
        c.inc("serving.requests_finished", 3)
        c.set("9lives", 0.5)
        c.set("queue-depth", 2)
        hists = {"staleness": mod.Histogram(4), "downlink.client_kb":
                 mod.Histogram(2)}
        hists["staleness"].observe_many([0, 0, 1, 3, 7])
        hists["downlink.client_kb"].observe_many([1, 5])
        texts.append((mod.prometheus_text(c, hists),
                      mod.prometheus_text(c, prefix="x"),
                      mod.prometheus_text(mod.Counters())))
    assert texts[0] == texts[1]
    assert texts[0][0].endswith("\n") and texts[0][2] == ""


def test_disabled_facade_keeps_history_and_refuses_a_sink(tmp_path):
    tel = ptel.Telemetry.disabled("sim")
    tel.record_round(0, {"x": 1.0})
    tel.record_eval({"round": 1, "acc": 0.5, "loss": 1.0})
    tel.record_request(SimpleNamespace(rid=0, tokens=[1], arrival_t=0.0,
                                       first_token_t=0.1, finish_t=0.2))
    assert list(tel.drift_curve) == [] and tel.counters.snapshot() == {}
    assert list(tel.history) == [{"round": 1, "acc": 0.5, "loss": 1.0}]
    assert tel.history.maxlen == ptel.core.HISTORY_MAXLEN
    assert tel.drift_curve.maxlen == ptel.core.DRIFT_CURVE_MAXLEN == 4096
    with pytest.raises(ValueError, match="disabled"):
        ptel.Telemetry(enabled=False, jsonl=str(tmp_path / "x.jsonl"))
    assert ptel.Telemetry().enabled and ptel.Telemetry().tracer.enabled
