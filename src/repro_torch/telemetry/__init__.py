"""The telemetry facade, disabled form only (counterpart of the JAX
package's ``telemetry/``; spans, drift diagnostics and exporters come with
the telemetry slice).

Engines take ``telemetry=`` and default to ``Telemetry.disabled()``.  The
disabled facade keeps what the engines return — the eval ``history`` — and
the counter registry the transport accounts its bytes into; its tracer's
``span`` is a no-op.
"""
from __future__ import annotations

import contextlib
from collections import deque
from typing import Dict

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

    def get(self, name: str, default: float = 0):
        return self._c.get(name, default)


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
        self.history: deque = deque(maxlen=HISTORY_MAXLEN)  # eval history

    @classmethod
    def disabled(cls, engine: str = "") -> "Telemetry":
        return cls(engine=engine)

    def record_eval(self, entry: dict) -> None:
        """One eval-history entry (this IS the engines' ``history``)."""
        self.history.append(entry)


__all__ = ["Telemetry", "Tracer", "Counters"]
