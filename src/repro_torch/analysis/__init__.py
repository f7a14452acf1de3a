"""repro_torch.analysis — the port's repo-contract analysis (counterpart of
the JAX package's ``analysis/``), in torch idiom.

* Layer 1 — AST checkers (``ast_rules.py``) encode the repo's shipped bug
  classes as named rules over ``src/repro_torch`` (its benchmarks among
  it) and ``chip_smoke.py``.
* Layer 2 — run-time audits (``trace_audit.py``) run the round engines at
  tiny sizes under a ``TorchDispatchMode``: the per-round cost does not
  grow, reductions accumulate in fp32, and every kernel has a plain
  version, a parity test and a check on the card.

Findings are emitted as JSONL on the telemetry event envelope
(``kind="finding"``), suppressed only through the committed
``analysis_baseline_torch.json``, and gate CI through
``python -m repro_torch.analysis --require-clean``.
"""
from repro_torch.analysis.findings import Finding, findings_to_jsonl
from repro_torch.analysis.baseline import Baseline, load_baseline
from repro_torch.analysis.ast_rules import RULES, run_ast_rules
from repro_torch.analysis.trace_audit import run_trace_audits

__all__ = [
    "Finding",
    "findings_to_jsonl",
    "Baseline",
    "load_baseline",
    "RULES",
    "run_ast_rules",
    "run_trace_audits",
]
