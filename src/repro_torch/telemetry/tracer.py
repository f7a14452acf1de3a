"""Host-side span tracing and the counter registry (counterpart of the JAX
package's ``telemetry/tracer.py``).

``Tracer`` times nested host-side phases with ``perf_counter``.  A span is
only meaningful where the host waits for the device, so ``span(...,
sync=tensors)`` waits on exit for the card's queued work before the clock
stops: ``torch.cuda.synchronize(device)`` once for each CUDA device among
the tensors given (any nesting of dicts, lists and tuples of tensors).
Tensors on the CPU need no wait, and the span touches no ``torch.cuda``
state for them.  Spans sit at the engines' dispatch boundaries: ``round``
(the synchronous simulator), ``local_train`` / ``aggregate`` /
``transport.encode`` (the async engine's dispatch groups, flushes and
broadcasts), ``prefill_chunk`` / ``decode_step`` (the serving engine).

``Counters`` is the one registry every byte and count statistic lives
behind: ``Transport`` accounts its wire counters into it, the paged store
and the serving engine publish gauges the same way.  ``Histogram`` is a
bounded summary: fixed integer bins plus an overflow bucket, with the
exact count, total and max kept beside them.

The disabled tracer's ``span`` is one shared no-op context manager, so a
telemetry-off engine pays an attribute lookup per span site and waits on
nothing.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterable


class _NullSpan:
    """Shared no-op span for the disabled tracer."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


def _cuda_devices(obj, found: set) -> set:
    """The CUDA devices of every tensor in ``obj`` (tensors, and dicts,
    lists and tuples of them, named tuples such as SparseLeaf included)."""
    if isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    elif getattr(obj, "is_cuda", False):
        found.add(obj.device)
    return found


class Span:
    """One timed host-side phase.  ``sync`` (the tensors the phase
    produced) is waited for before the clock stops, so the duration covers
    the device work the phase launched, not just the Python that launched
    it."""

    __slots__ = ("tracer", "name", "sync", "t0")

    def __init__(self, tracer: "Tracer", name: str, sync=None):
        self.tracer = tracer
        self.name = name
        self.sync = sync
        self.t0 = 0.0

    def __enter__(self):
        self.tracer._stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.sync is not None:
            devices = _cuda_devices(self.sync, set())
            if devices:
                import torch
                for dev in devices:
                    torch.cuda.synchronize(dev)
        dur = time.perf_counter() - self.t0
        self.tracer._stack.pop()
        self.tracer._record(self.name, dur)
        return False


class Tracer:
    """Nested span timing with bounded per-name duration reservoirs.

    Span names nest with ``/`` (a span opened inside another records as
    ``outer/inner``), and per-name statistics keep the most recent
    ``maxlen`` durations for percentiles plus the exact count and total.
    """

    def __init__(self, enabled: bool = True, maxlen: int = 4096):
        self.enabled = enabled
        self.maxlen = maxlen
        self._stack: list = []
        self._durs: Dict[str, deque] = {}
        self._count: Dict[str, int] = {}
        self._total: Dict[str, float] = {}

    def span(self, name: str, sync=None):
        """Context manager timing one phase; no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        if self._stack:
            name = f"{self._stack[-1]}/{name}"
        return Span(self, name, sync)

    def _record(self, name: str, dur: float) -> None:
        if name not in self._durs:
            self._durs[name] = deque(maxlen=self.maxlen)
            self._count[name] = 0
            self._total[name] = 0.0
        self._durs[name].append(dur)
        self._count[name] += 1
        self._total[name] += dur

    def timings(self, name: str) -> list:
        """The retained durations (seconds) for one span name."""
        return list(self._durs.get(name, ()))

    def summary(self) -> Dict[str, Dict[str, float]]:
        """Per-span count/total and p50/p95 over the retained reservoir."""
        out = {}
        for name, durs in self._durs.items():
            s = sorted(durs)
            n = len(s)
            out[name] = {
                "count": self._count[name],
                "total_s": round(self._total[name], 6),
                "p50_s": round(s[n // 2], 6),
                "p95_s": round(s[min(n - 1, int(0.95 * n))], 6),
            }
        return out


class Counters:
    """Named monotonic counters and gauges — one snapshot-able registry.

    ``inc`` is the counter path (transport bytes, event counts); ``set``
    the gauge path (queue depth, slot occupancy, the paged store's
    resident pages).  Missing names read 0, so call sites never
    pre-register.
    """

    def __init__(self):
        self._c: Dict[str, float] = {}

    def inc(self, name: str, value: float = 1) -> None:
        self._c[name] = self._c.get(name, 0) + value

    def set(self, name: str, value: float) -> None:
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
