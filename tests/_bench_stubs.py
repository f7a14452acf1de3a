"""Recording stand-ins for ``run_fl`` / ``run_fl_async`` in the
communication and telemetry benchmark drivers (``comm_sweep``,
``telemetry_bench``), shared by the port's benchmark tests.

Each call is recorded without its device and its telemetry object (only
whether one was given), and everything it returns — accuracy, µs per
round, the four byte counters, the unicast catch-ups and resyncs, the
staleness mean and, when a telemetry object is given, three rounds of
drift diagnostics with the key set the engine would record — is a hash of
the call.  Two drivers that make the same calls then print the same rows
and write the same JSON.
"""
import dataclasses
import hashlib
from types import SimpleNamespace

import numpy as np
import torch


def digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.tobytes() if isinstance(p, np.ndarray) else
                 repr(p).encode())
    return h.hexdigest()


class CommStub:
    """``run_fl`` / ``run_fl_async`` for one driver module; ``calls`` keeps
    (engine, strategy, keywords, hetero, telemetry given) per call."""

    def __init__(self, common, port):
        self.common, self.port, self.calls = common, port, []

    def _run(self, engine, strategy, parts, data, hetero, kw):
        kw = dict(kw)
        if self.port:
            assert kw.pop("device") == "cpu"
        assert data is self.common.dataset()
        tel = kw.pop("telemetry", None)
        het = dataclasses.asdict(hetero) if hetero is not None else None
        key = digest(engine, strategy, sorted(kw.items()), het, *parts)
        self.calls.append((engine, strategy, sorted(kw.items()), het,
                           tel is not None))
        v = int(key[:15], 16)
        extra = kw.get("extra_fed") or {}
        if tel is not None:
            for t in range(3):
                m = {"delta_dispersion": (v >> t) % 997 / 997,
                     "update_norm": (v >> (t + 3)) % 991 / 991}
                if strategy != "fedavg":
                    m["momentum_alignment"] = (v >> (t + 5)) % 983 / 983
                if extra.get("error_feedback") and engine == "sync":
                    m["ef_residual_norm"] = (v >> (t + 7)) % 977 / 977
                m["loss"] = (v >> (t + 9)) % 971 / 97
                if engine == "async":
                    m["staleness_mean"] = float(t % 2)
                    m["staleness_max"] = float(t)
                tel.record_round(t, m)
        sim = SimpleNamespace(
            uplink_bytes=1 + v % 4099, uplink_bytes_raw=5000 + v % 9973,
            downlink_bytes=v % 7919, downlink_bytes_raw=v % 8999,
            staleness_hist=SimpleNamespace(mean=lambda: (v % 89) / 31),
            refs=SimpleNamespace(catchups=v % 13, resyncs=v % 11),
            transport=SimpleNamespace(_down_nbytes=v % 101,
                                      _down_raw=v % 103),
            params={}, device=torch.device("cpu"))
        return {"acc": (v % 1000) / 1000, "loss": 1.0,
                "us_per_round": float(v % 99991), "hist": [], "sim": sim}

    def run_fl(self, strategy, parts, data, **kw):
        return self._run("sync", strategy, parts, data, None, kw)

    def run_fl_async(self, strategy, parts, data, *, hetero, **kw):
        return self._run("async", strategy, parts, data, hetero, kw)


def stub_comm(monkeypatch, module, common, port):
    """Put a ``CommStub``'s runners into a driver module, and a ``Clock``
    in place of its ``time`` where it reads one -> the stub."""
    stub = CommStub(common, port)
    monkeypatch.setattr(module, "run_fl", stub.run_fl)
    if hasattr(module, "run_fl_async"):
        monkeypatch.setattr(module, "run_fl_async", stub.run_fl_async)
    if hasattr(module, "time"):
        monkeypatch.setattr(module, "time", Clock())
    return stub


class Clock:
    """A ``time`` stand-in whose ``perf_counter`` ticks one second a call,
    so a driver's wall-clock ratios are exactly 1."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 1.0
        return self.t

    time = perf_counter
