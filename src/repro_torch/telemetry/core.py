"""The ``Telemetry`` facade (counterpart of the JAX package's
``telemetry/core.py``): one object per engine composing the tracer, the
counter registry, bounded histograms, the drift-curve buffer and the JSONL
sink.

Contract with the engines:

* **disabled changes nothing** — ``Telemetry.disabled()`` is the engines'
  default; they branch on its ``enabled`` flag, so a disabled round makes
  exactly the launches and the bits it makes without telemetry.
* **one fetch per round** — engines hand ``record_round`` the metric dict
  already on the host (one device-to-host transfer of the round's
  scalars); the facade never touches device tensors itself.
* **the engines' history lives here** — ``record_eval`` appends to
  ``history`` (a deque bounded at ``HISTORY_MAXLEN``) even when disabled,
  and ``Transport`` accounts its byte counters into ``counters``.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Optional

from repro_torch.telemetry.export import JsonlSink, prometheus_text
from repro_torch.telemetry.latency import latency_summary, request_itl
from repro_torch.telemetry.tracer import Counters, Histogram, Tracer

DRIFT_CURVE_MAXLEN = 4096
# the eval history is bounded like the drift curve: a run that evaluates
# more often than this keeps the most recent entries
HISTORY_MAXLEN = 65536


class Telemetry:
    def __init__(self, enabled: bool = True, jsonl=None, engine: str = ""):
        self.enabled = enabled
        self.engine = engine
        self.tracer = Tracer(enabled)
        self.counters = Counters()
        self.histograms: Dict[str, Histogram] = {}
        self.history: deque = deque(maxlen=HISTORY_MAXLEN)  # eval history
        # bounded per-round drift record: {"round": t, <metric>: float, ...}
        self.drift_curve: deque = deque(maxlen=DRIFT_CURVE_MAXLEN)
        self._sink: Optional[JsonlSink] = None
        if jsonl is not None:
            if not enabled:
                raise ValueError("a JSONL sink on disabled telemetry would "
                                 "silently record nothing; pass enabled=True")
            self._sink = JsonlSink(jsonl)

    @classmethod
    def disabled(cls, engine: str = "") -> "Telemetry":
        return cls(enabled=False, engine=engine)

    # ------------------------------------------------------------------
    def histogram(self, name: str, n_bins: int = 32) -> Histogram:
        """Get-or-create a named bounded histogram."""
        if name not in self.histograms:
            self.histograms[name] = Histogram(n_bins)
        return self.histograms[name]

    def emit(self, kind: str, **fields) -> None:
        """Emit one schema-validated event to the JSONL sink (no-op when
        disabled or sink-less; counters and curves update regardless
        through the record_* helpers)."""
        if not self.enabled or self._sink is None:
            return
        self._sink.emit({"ts": time.time(), "kind": kind,
                         "engine": self.engine, **fields})

    # ------------------------------------------------------------------
    def record_round(self, round_idx: int, metrics: Dict[str, float],
                     **extra) -> None:
        """One round's drift diagnostics (already fetched to the host)."""
        if not self.enabled:
            return
        metrics = {k: float(v) for k, v in metrics.items()}
        self.drift_curve.append({"round": int(round_idx), **metrics})
        self.counters.inc("rounds")
        self.emit("round", round=int(round_idx), metrics=metrics, **extra)

    def record_eval(self, entry: dict) -> None:
        """One eval-history entry, appended even when disabled (this IS the
        engines' ``history``: observability must not change what the engine
        returns)."""
        self.history.append(entry)
        if self.enabled:
            self.emit("eval", **{k: (float(v) if isinstance(v, float)
                                     else v) for k, v in entry.items()})

    def record_request(self, output, **extra) -> None:
        """One finished serving request: TTFT/ITL/e2e from its raw
        timestamps."""
        if not self.enabled:
            return
        self.counters.inc("serving.requests_finished")
        self.counters.inc("serving.tokens_generated", len(output.tokens))
        self.emit("request", rid=int(output.rid),
                  n_tokens=len(output.tokens),
                  ttft_s=float(output.first_token_t - output.arrival_t),
                  itl_s=request_itl(output),
                  e2e_s=float(output.finish_t - output.arrival_t), **extra)

    # ------------------------------------------------------------------
    def drift_summary(self) -> Dict[str, object]:
        """First/last points of each drift metric seen this run."""
        if not self.drift_curve:
            return {}
        first, last = self.drift_curve[0], self.drift_curve[-1]
        keys = [k for k in last if k != "round"]
        return {k: {"first": first.get(k), "last": last[k]} for k in keys}

    def summary(self, outputs=None) -> Dict[str, object]:
        """End-of-run summary: counters, span percentiles, histograms,
        drift curve endpoints, and (if serving outputs are passed) the
        TTFT/ITL/e2e latency summary."""
        s: Dict[str, object] = {
            "engine": self.engine,
            "counters": self.counters.snapshot(),
            "spans": self.tracer.summary(),
            "histograms": {k: h.to_dict()
                           for k, h in self.histograms.items()},
            "drift": self.drift_summary(),
        }
        if outputs:
            s["latency"] = latency_summary(outputs)
        return s

    def emit_summary(self, outputs=None, **extra) -> Dict[str, object]:
        s = self.summary(outputs)
        self.emit("summary", **{k: v for k, v in s.items()
                                if k != "engine"}, **extra)
        return s

    def prometheus(self) -> str:
        return prometheus_text(self.counters, self.histograms)

    def close(self) -> None:
        if self._sink is not None:
            self._sink.close()
