"""Bench-smoke regression gate of the port (CI), a copy of
``benchmarks/check_regression.py`` for the ``BENCH_*_torch.json`` files.

Compares a freshly emitted ``BENCH_*_torch.json`` against the committed copy:
every numeric field reachable at the same path must agree within a relative
tolerance (default 20%), and booleans/strings must match exactly.  Wall-
clock-derived fields (runner-speed dependent) are skipped by key pattern so
the gate checks *what* the benchmark measured, not how fast the runner was.

The tolerance is relative with an absolute floor (``--atol``): derived
difference-of-large-numbers fields (e.g. an accuracy *gap* of 0.0017) must
not be gated orders of magnitude tighter than the quantities they were
computed from.

``--require`` names dotted paths (e.g. ``headline.downlink_measured``,
``async_cells``, ``drift.fedadc_none``) that must exist and be
truthy/non-empty in the FRESH output of every compared pair — the walk
itself is committed-driven, so this is how the gate pins *new* sections a
refactor promised (a fresh file that silently stopped emitting them would
otherwise still pass).  Everything *under* a required path is additionally
checked to be well-formed — numeric leaves must be finite (a drift metric
that collapsed to NaN/inf is a regression even though NaN != NaN would
slip through an equality diff) — while wall-clock keys inside the section
stay skipped.

Usage:  python -m repro_torch.benchmarks.check_regression \\
            fresh.json:committed.json \\
            [--tol 0.2] [--atol 0.01] [--require path ...]
Exit code 1 on any violation, with a per-path report (``main`` returns
it).
"""
from __future__ import annotations

import argparse
import json
import math
import re
import sys

# runner-speed dependent fields; excluded from the gate
SKIP_KEY = re.compile(
    r"(wall|latency|per_s|per_round|per_tok|us_|_us|speedup|time)", re.I)


def _walk(fresh, committed, path, tol, atol, errors):
    if isinstance(committed, dict):
        if not isinstance(fresh, dict):
            errors.append(f"{path}: type changed ({type(fresh).__name__})")
            return
        for k, cv in committed.items():
            if SKIP_KEY.search(str(k)):
                continue
            if k not in fresh:
                errors.append(f"{path}.{k}: missing from fresh output")
                continue
            _walk(fresh[k], cv, f"{path}.{k}", tol, atol, errors)
    elif isinstance(committed, list):
        if not isinstance(fresh, list) or len(fresh) != len(committed):
            errors.append(f"{path}: list length {len(fresh) if isinstance(fresh, list) else '?'} "
                          f"!= {len(committed)}")
            return
        for i, (fv, cv) in enumerate(zip(fresh, committed)):
            _walk(fv, cv, f"{path}[{i}]", tol, atol, errors)
    elif isinstance(committed, bool):
        if fresh is not committed:
            errors.append(f"{path}: {fresh!r} != committed {committed!r}")
    elif isinstance(committed, (int, float)):
        if not isinstance(fresh, (int, float)):
            errors.append(f"{path}: non-numeric {fresh!r}")
        else:
            bound = max(tol * abs(committed), atol)
            diff = abs(fresh - committed)
            if diff > bound:
                errors.append(f"{path}: {fresh} vs committed {committed} "
                              f"(|diff| {diff:.4g} > {bound:.4g})")
    else:
        if fresh != committed:
            errors.append(f"{path}: {fresh!r} != committed {committed!r}")


def _check_finite(node, path, errors):
    """Numeric leaves under a required section must be finite; wall-clock
    keys are skipped exactly as in the committed-driven walk."""
    if isinstance(node, dict):
        for k, v in node.items():
            if SKIP_KEY.search(str(k)):
                continue
            _check_finite(v, f"{path}.{k}", errors)
    elif isinstance(node, list):
        for i, v in enumerate(node):
            _check_finite(v, f"{path}[{i}]", errors)
    elif isinstance(node, float) and not math.isfinite(node):
        errors.append(f"required path {path}: non-finite value {node!r}")


def _check_required(fresh, paths, errors):
    for dotted in paths:
        node = fresh
        ok = True
        for part in dotted.split("."):
            if isinstance(node, dict) and part in node:
                node = node[part]
            else:
                ok = False
                break
        if not ok:
            errors.append(f"required path {dotted!r} missing from fresh "
                          f"output")
        elif isinstance(node, (list, dict)) and not node:
            errors.append(f"required path {dotted!r} is empty")
        elif node is False or node is None:
            errors.append(f"required path {dotted!r} is {node!r}")
        else:
            _check_finite(node, dotted, errors)


def compare(fresh_path: str, committed_path: str, tol: float = 0.2,
            atol: float = 0.01, require=()):
    with open(fresh_path) as f:
        fresh = json.load(f)
    with open(committed_path) as f:
        committed = json.load(f)
    errors: list = []
    _walk(fresh, committed, "$", tol, atol, errors)
    _check_required(fresh, require, errors)
    return errors


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("pairs", nargs="+",
                    help="fresh.json:committed.json pairs")
    ap.add_argument("--tol", type=float, default=0.2)
    ap.add_argument("--atol", type=float, default=0.01)
    ap.add_argument("--require", nargs="*", default=[],
                    help="dotted paths that must exist (truthy/non-empty) "
                         "in every fresh output")
    args = ap.parse_args(argv)
    failed = False
    for pair in args.pairs:
        fresh, committed = pair.split(":")
        errors = compare(fresh, committed, args.tol, args.atol,
                         args.require)
        if errors:
            failed = True
            print(f"REGRESSION {fresh} vs {committed}:")
            for e in errors:
                print(f"  {e}")
        else:
            print(f"OK {fresh} vs {committed} (tol {args.tol:.0%})")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
