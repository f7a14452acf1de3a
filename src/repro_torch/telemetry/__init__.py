"""The telemetry facade, disabled form only (counterpart of the JAX
package's ``telemetry/``; spans, drift diagnostics and exporters come with
the telemetry slice).

Engines take ``telemetry=`` and default to ``Telemetry.disabled()``.  The
disabled facade keeps what the engines return — the eval ``history`` — and
the counter registry the transport accounts its bytes into (and the paged
store its gauges), and the named histograms (the downlink's per-client
payload sizes, the async engine's staleness); its tracer's ``span``
is a no-op, and so are the serving engine's ``record_request`` and
``emit_summary``.  ``latency_summary`` (``telemetry/latency.py``) turns
finished requests into the serving percentiles.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict, Iterable

from repro_torch.telemetry.latency import latency_summary, request_itl

# the eval history is bounded like the reference's drift curve: a run that
# evaluates more often than this keeps the most recent entries
HISTORY_MAXLEN = 65536


class Counters:
    """Named monotonic counters — one snapshot-able registry.  Missing names
    read 0, so call sites never pre-register."""

    def __init__(self):
        self._c: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        self._c[name] = self._c.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
        """A gauge: the value replaces the last one (the paged store's
        resident pages and bytes)."""
        self._c[name] = value

    def get(self, name: str, default: float = 0):
        return self._c.get(name, default)

    def snapshot(self) -> Dict[str, float]:
        return dict(self._c)

    def __contains__(self, name: str) -> bool:
        return name in self._c


class Histogram:
    """Bounded integer histogram: bins ``0..n_bins-1`` plus an overflow
    bucket, with the exact count, total and max kept beside them, so its
    memory stays O(n_bins) for any number of observations."""

    def __init__(self, n_bins: int = 32):
        if n_bins < 1:
            raise ValueError("Histogram needs at least one bin")
        self.n_bins = n_bins
        self.bins = [0] * n_bins
        self.overflow = 0
        self.count = 0
        self.total = 0
        self.max = 0

    def observe(self, value: int) -> None:
        v = int(value)
        if v < 0:
            raise ValueError(f"Histogram observes non-negative ints, got {v}")
        if v < self.n_bins:
            self.bins[v] += 1
        else:
            self.overflow += 1
        self.count += 1
        self.total += v
        self.max = max(self.max, v)

    def observe_many(self, values: Iterable[int]) -> None:
        for v in values:
            self.observe(v)

    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def reset(self) -> None:
        self.bins = [0] * self.n_bins
        self.overflow = 0
        self.count = 0
        self.total = 0
        self.max = 0

    def to_dict(self) -> Dict[str, object]:
        """The reference's export: trailing all-zero bins trimmed."""
        last = max((i for i, b in enumerate(self.bins) if b), default=-1)
        return {"bins": self.bins[:last + 1], "overflow": self.overflow,
                "count": self.count, "mean": round(self.mean(), 4),
                "max": self.max}


class Tracer:
    """Span tracing; this slice has only the disabled tracer."""

    def span(self, name: str):
        return contextlib.nullcontext()


class Telemetry:
    def __init__(self, engine: str = ""):
        self.enabled = False
        self.engine = engine
        self.tracer = Tracer()
        self.counters = Counters()
        self.histograms: Dict[str, Histogram] = {}
        self.history: deque = deque(maxlen=HISTORY_MAXLEN)  # eval history

    @classmethod
    def disabled(cls, engine: str = "") -> "Telemetry":
        return cls(engine=engine)

    def histogram(self, name: str, n_bins: int = 32) -> Histogram:
        """Get-or-create a named bounded histogram."""
        if name not in self.histograms:
            self.histograms[name] = Histogram(n_bins)
        return self.histograms[name]

    def record_eval(self, entry: dict) -> None:
        """One eval-history entry (this IS the engines' ``history``)."""
        self.history.append(entry)

    def record_request(self, output, **extra) -> None:
        """One finished serving request: the disabled facade records
        nothing (the reference's counters and event come with the
        telemetry slice)."""

    def emit_summary(self, outputs=None, **extra) -> None:
        """The end-of-run serving summary: nothing to emit when disabled."""


__all__ = ["Telemetry", "Tracer", "Counters", "Histogram", "latency_summary",
           "request_itl"]
