"""``python -m repro_torch.analysis`` — run the port's repo-contract
analysis pass (counterpart of the JAX package's ``analysis/cli.py``).

Exit codes: 0 clean (no unsuppressed findings; with ``--require-clean``
also no stale baseline entries), 1 findings or stale suppressions, 2 usage
error.  ``--jsonl`` writes every finding (suppressed included, flagged) as
telemetry-envelope JSONL for the CI artifact.
"""
from __future__ import annotations

import argparse
import os
import sys

from repro_torch.analysis import ast_rules, trace_audit
from repro_torch.analysis.baseline import load_baseline, write_baseline
from repro_torch.analysis.findings import findings_to_jsonl, sort_findings


def repo_root() -> str:
    """src/repro_torch/analysis/cli.py -> the repo checkout root."""
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.abspath(os.path.join(here, "..", "..", ".."))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's repo-contract analysis "
                    "(AST lints + run-time audits under a dispatch mode)")
    p.add_argument("--root", default=None,
                   help="repo root (default: derived from the package path)")
    p.add_argument("--baseline", default=None,
                   help="suppression file (default: ROOT/analysis_baseline"
                        "_torch.json)")
    p.add_argument("--jsonl", default=None,
                   help="write all findings as telemetry-envelope JSONL")
    p.add_argument("--require-clean", action="store_true",
                   help="exit 1 on any unsuppressed finding OR stale "
                        "baseline entry (the CI gate)")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to cover current findings "
                        "(reasons must then be filled in by hand)")
    p.add_argument("--skip-trace", action="store_true",
                   help="AST layer only (fast; no engine runs)")
    p.add_argument("--skip-retrace", action="store_true",
                   help="skip the (slowest) per-round audit, keep the "
                        "accumulation and kernel-coverage audits")
    p.add_argument("--rules", default=None,
                   help="comma-separated AST rule subset")
    p.add_argument("--list-rules", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.list_rules:
        for rid in sorted(ast_rules.RULES):
            print(rid)
        for rid in ("trace-retrace", "trace-accumulation-dtype",
                    "trace-kernel-coverage"):
            print(rid)
        return 0

    root = os.path.abspath(args.root) if args.root else repo_root()
    baseline_path = args.baseline or os.path.join(
        root, "analysis_baseline_torch.json")

    rules = None
    if args.rules:
        wanted = set(args.rules.split(","))
        unknown = wanted - set(ast_rules.RULES)
        if unknown:
            print(f"unknown rules: {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2
        rules = {k: v for k, v in ast_rules.RULES.items() if k in wanted}

    findings = ast_rules.run_ast_rules(root, rules=rules)
    if not args.skip_trace:
        findings.extend(trace_audit.run_trace_audits(
            root, include_retrace=not args.skip_retrace))
    findings = sort_findings(findings)

    if args.update_baseline:
        write_baseline(baseline_path, findings)
        print(f"wrote {len(findings)} entries to {baseline_path} — fill in "
              f"the reasons before committing")
        return 0

    try:
        baseline = load_baseline(baseline_path)
    except ValueError as e:
        print(f"invalid baseline: {e}", file=sys.stderr)
        return 2
    new, suppressed, stale = baseline.apply(findings)

    everything = sort_findings(new + suppressed)
    for f in everything:
        print(f.format())
    if args.jsonl:
        findings_to_jsonl(everything, args.jsonl)
        print(f"wrote {len(everything)} findings to {args.jsonl}")

    for e in stale:
        print(f"STALE baseline entry (no longer fires): "
              f"{e['rule']} @ {e['path']} :: {e['snippet']!r}",
              file=sys.stderr)

    print(f"{len(new)} finding(s), {len(suppressed)} suppressed, "
          f"{len(stale)} stale baseline "
          f"entr{'y' if len(stale) == 1 else 'ies'}")
    if new:
        return 1
    if args.require_clean and stale:
        return 1
    return 0
