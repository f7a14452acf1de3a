"""Finding objects and their JSONL wire format (a copy of the JAX
package's ``analysis/findings.py``).

A finding is one rule violation at one source location.  Its *identity* for
baseline-suppression purposes is ``(rule, path, context, snippet)`` — the
enclosing def/class chain plus the normalised source line, NOT the line
number, so unrelated edits above a suppressed site don't resurrect it and
moving the offending line doesn't silently un-suppress a new copy.

The JSONL export reuses the telemetry event envelope (``ts``/``kind``/
``engine`` with ``kind="finding"``, ``engine="analysis"``) so the CI
artifact validates under ``python -m repro_torch.telemetry.schema`` like every
other event stream in the repo.
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Iterable, List, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str            # rule id, e.g. "truthiness-on-config"
    path: str            # repo-relative posix path
    line: int            # 1-based line number (display only, not identity)
    message: str         # human-readable defect statement
    context: str = ""    # enclosing Class.func dotted chain ("" = module)
    snippet: str = ""    # stripped source line at `line`
    suppressed: bool = False  # True once matched against the baseline

    def key(self) -> Tuple[str, str, str, str]:
        """Baseline-identity key (line-number free)."""
        return (self.rule, self.path, self.context, self.snippet)

    def to_event(self, ts: float) -> dict:
        return {
            "ts": ts,
            "kind": "finding",
            "engine": "analysis",
            "rule": self.rule,
            "path": self.path,
            "line": self.line,
            "message": self.message,
            "context": self.context,
            "snippet": self.snippet,
            "suppressed": self.suppressed,
        }

    def format(self) -> str:
        tag = " [baseline]" if self.suppressed else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.message}{tag}"


def findings_to_jsonl(findings: Iterable[Finding], path: str,
                      ts: float | None = None) -> int:
    """Write findings as schema-valid telemetry JSONL; returns the count."""
    from repro_torch.telemetry.schema import validate_event

    ts = time.time() if ts is None else ts
    n = 0
    with open(path, "w") as f:
        for fi in findings:
            event = fi.to_event(ts)
            validate_event(event)
            f.write(json.dumps(event) + "\n")
            n += 1
    return n


def sort_findings(findings: Iterable[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))
