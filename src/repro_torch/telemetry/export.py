"""Telemetry exporters (counterpart of the JAX package's
``telemetry/export.py``): the JSONL event sink and the Prometheus-style
text dump.

``JsonlSink`` writes one schema-validated JSON object per line, append-only,
flushed after each event so a crashed run keeps everything emitted before
the crash.  ``prometheus_text`` renders a ``Counters`` snapshot (plus
optional histograms) in the Prometheus exposition text format, with metric
names sanitised to ``[a-zA-Z_][a-zA-Z0-9_]*`` (dots become underscores).
"""
from __future__ import annotations

import json
import re
from typing import Dict, Optional

from repro_torch.telemetry.schema import validate_event
from repro_torch.telemetry.tracer import Counters, Histogram

_NAME_OK = re.compile(r"[^a-zA-Z0-9_]")


class JsonlSink:
    """Append-only JSONL event sink.  Accepts a path (opened and owned) or
    any object with ``write`` (borrowed: not closed)."""

    def __init__(self, target):
        if hasattr(target, "write"):
            self._f, self._owns = target, False
        else:
            self._f, self._owns = open(target, "a"), True
        self.n_events = 0

    def emit(self, event: dict) -> None:
        validate_event(event)
        self._f.write(json.dumps(event, sort_keys=True) + "\n")
        self._f.flush()
        self.n_events += 1

    def close(self) -> None:
        if self._owns and not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


def _sanitize(name: str) -> str:
    name = _NAME_OK.sub("_", name)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def prometheus_text(counters: Counters,
                    histograms: Optional[Dict[str, Histogram]] = None,
                    prefix: str = "repro") -> str:
    """A ``Counters`` snapshot (+ histograms) in Prometheus text format.

    Every counter is exposed as an untyped gauge (the dump is for scraping
    and diffing); histograms expose the ``_bucket{le=...}`` / ``_sum`` /
    ``_count`` triple, cumulative buckets closed by ``+Inf``.  The text is
    the reference's, character for character.
    """
    lines = []
    for name, value in sorted(counters.snapshot().items()):
        metric = _sanitize(f"{prefix}_{name}")
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric} {value}")
    for name, hist in sorted((histograms or {}).items()):
        metric = _sanitize(f"{prefix}_{name}")
        lines.append(f"# TYPE {metric} histogram")
        cum = 0
        for i, b in enumerate(hist.bins):
            cum += b
            lines.append(f'{metric}_bucket{{le="{i}"}} {cum}')
        lines.append(f'{metric}_bucket{{le="+Inf"}} {hist.count}')
        lines.append(f"{metric}_sum {hist.total}")
        lines.append(f"{metric}_count {hist.count}")
    return "\n".join(lines) + ("\n" if lines else "")
