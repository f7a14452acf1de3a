"""Observability (counterpart of the JAX package's ``telemetry/``).

Three layers:

* :mod:`repro_torch.telemetry.drift` — the per-round drift diagnostics,
  scalar reductions over the round's deltas (a few fp32 scalars and one
  host fetch a round; the disabled path computes none of them);
* :mod:`repro_torch.telemetry.tracer` — host-side span tracing
  (``Tracer``, whose spans wait for the card's work before the clock
  stops) plus the ``Counters`` registry and bounded ``Histogram``;
* :mod:`repro_torch.telemetry.export` / :mod:`~.schema` /
  :mod:`~.latency` — the JSONL sink, the Prometheus text dump, the
  validated event schema, and serving latency percentiles.

``Telemetry`` (:mod:`repro_torch.telemetry.core`) composes them; every
engine takes ``telemetry=`` and defaults to ``Telemetry.disabled()``.
"""
from repro_torch.telemetry.core import Telemetry
from repro_torch.telemetry.drift import (delta_dispersion, ef_residual_norm,
                                         momentum_alignment, round_metrics,
                                         streaming_dispersion,
                                         streaming_sq_norm, update_norm)
from repro_torch.telemetry.export import JsonlSink, prometheus_text
from repro_torch.telemetry.latency import latency_summary, request_itl
from repro_torch.telemetry.schema import (EVENT_SCHEMA, validate_event,
                                          validate_jsonl)
from repro_torch.telemetry.tracer import Counters, Histogram, Span, Tracer

__all__ = [
    "Telemetry",
    "Tracer", "Span", "Counters", "Histogram",
    "JsonlSink", "prometheus_text",
    "latency_summary", "request_itl",
    "EVENT_SCHEMA", "validate_event", "validate_jsonl",
    "round_metrics", "delta_dispersion", "momentum_alignment",
    "ef_residual_norm", "update_norm",
    "streaming_sq_norm", "streaming_dispersion",
]
