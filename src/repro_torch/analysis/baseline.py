"""The committed suppression baseline of the port
(``analysis_baseline_torch.json``; a copy of the JAX package's
``analysis/baseline.py``, same format).

The baseline is the ONLY way to suppress a finding — there are no inline
``# noqa`` escapes, so every accepted violation is visible in one reviewed
file with a written reason.  Each entry carries the finding's
line-number-free identity key plus a mandatory ``reason``.

Baselines must stay *minimal*: entries that no longer match any current
finding are "stale" and fail ``--require-clean`` (and a tier-1 test), so
fixed code can't leave ghost suppressions behind.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import Finding

BASELINE_VERSION = 1

Key = Tuple[str, str, str, str]


@dataclasses.dataclass
class Baseline:
    entries: List[dict] = dataclasses.field(default_factory=list)
    path: str = ""

    def keys(self) -> Dict[Key, dict]:
        out: Dict[Key, dict] = {}
        for e in self.entries:
            out[(e["rule"], e["path"], e.get("context", ""),
                 e.get("snippet", ""))] = e
        return out

    def apply(self, findings: List[Finding]):
        """Split findings into (new, suppressed) and report stale entries.

        Returns ``(new, suppressed, stale)`` where ``stale`` is the list of
        baseline entries that matched nothing.
        """
        keymap = self.keys()
        hit = set()
        new, suppressed = [], []
        for f in findings:
            k = f.key()
            if k in keymap:
                hit.add(k)
                suppressed.append(dataclasses.replace(f, suppressed=True))
            else:
                new.append(f)
        stale = [e for k, e in keymap.items() if k not in hit]
        return new, suppressed, stale


def load_baseline(path: str) -> Baseline:
    try:
        with open(path) as f:
            data = json.load(f)
    except FileNotFoundError:
        return Baseline(entries=[], path=path)
    if data.get("version") != BASELINE_VERSION:
        raise ValueError(f"{path}: unsupported baseline version "
                         f"{data.get('version')!r}")
    entries = data.get("entries", [])
    for i, e in enumerate(entries):
        for field in ("rule", "path", "snippet", "reason"):
            if not isinstance(e.get(field), str) or not e.get(field):
                raise ValueError(
                    f"{path}: entry {i} missing/empty field {field!r} "
                    f"(every suppression needs a written reason)")
    return Baseline(entries=entries, path=path)


def write_baseline(path: str, findings: List[Finding],
                   reason: str = "TODO: justify this suppression") -> None:
    """Emit a baseline file covering ``findings`` (used by ``--update``)."""
    entries = [
        {"rule": f.rule, "path": f.path, "context": f.context,
         "snippet": f.snippet, "reason": reason}
        for f in findings
    ]
    with open(path, "w") as fp:
        json.dump({"version": BASELINE_VERSION, "entries": entries},
                  fp, indent=2, sort_keys=False)
        fp.write("\n")
