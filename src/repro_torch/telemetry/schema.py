"""The telemetry event schema (a copy of the JAX package's
``telemetry/schema.py``), validated at emit time and over exported files.

Every event is one JSON object (one JSONL line) with the common envelope

    {"ts": <float unix seconds>, "kind": <str>, "engine": <str>, ...}

and per-kind required fields:

    round    — round (int), metrics (dict[str, number]): the drift
               diagnostics fetched once per round
    eval     — round (int), acc (number), loss (number)
    request  — rid (int), n_tokens (int), ttft_s/e2e_s (number),
               itl_s (number or null: single-token requests have no
               inter-token gap)
    summary  — counters (dict[str, number]); spans / latency / drift /
               histograms ride as optional structured extras
    finding  — rule, path, message (str), line (int): static-analysis
               findings on the same envelope

Unknown extra fields are allowed everywhere (the schema is a floor, not a
ceiling); unknown *kinds* are rejected so producers cannot silently fork
the vocabulary.  A bool is not a number here.

Validate exported files with:

    python -m repro_torch.telemetry.schema FILE.jsonl ...

which prints ``OK`` a file and exits 0, 1 if any file is invalid, and 2
without arguments.
"""
from __future__ import annotations

import json
import sys
from typing import Dict

_NUM = (int, float)

# kind -> {field: type tuple (a NoneType entry means nullable)}
EVENT_SCHEMA: Dict[str, Dict[str, tuple]] = {
    "round": {"round": (int,), "metrics": (dict,)},
    "eval": {"round": (int,), "acc": _NUM, "loss": _NUM},
    "request": {"rid": (int,), "n_tokens": (int,), "ttft_s": _NUM,
                "itl_s": _NUM + (type(None),), "e2e_s": _NUM},
    "summary": {"counters": (dict,)},
    "finding": {"rule": (str,), "path": (str,), "line": (int,),
                "message": (str,)},
}


def validate_event(event: dict) -> None:
    """Raise ``ValueError`` unless ``event`` satisfies the schema."""
    if not isinstance(event, dict):
        raise ValueError(f"event must be a JSON object, got "
                         f"{type(event).__name__}")
    for field, types in (("ts", _NUM), ("kind", (str,)), ("engine", (str,))):
        if field not in event:
            raise ValueError(f"event missing required field {field!r}: "
                             f"{event!r}")
        if not isinstance(event[field], types) \
                or isinstance(event[field], bool):
            raise ValueError(f"event field {field!r} has wrong type "
                             f"{type(event[field]).__name__}: {event!r}")
    kind = event["kind"]
    if kind not in EVENT_SCHEMA:
        raise ValueError(f"unknown event kind {kind!r}; known: "
                         f"{', '.join(sorted(EVENT_SCHEMA))}")
    for field, types in EVENT_SCHEMA[kind].items():
        if field not in event:
            raise ValueError(f"{kind!r} event missing field {field!r}: "
                             f"{event!r}")
        v = event[field]
        if not isinstance(v, types) or (isinstance(v, bool)
                                        and bool not in types):
            raise ValueError(f"{kind!r} event field {field!r} has wrong "
                             f"type {type(v).__name__}: {event!r}")
    if kind == "round":
        for k, v in event["metrics"].items():
            if not isinstance(v, _NUM) or isinstance(v, bool):
                raise ValueError(f"round metric {k!r} must be numeric, got "
                                 f"{type(v).__name__}")


def validate_jsonl(path: str) -> int:
    """Validate every line of a JSONL export; returns the event count."""
    n = 0
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                event = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{lineno}: not valid JSON: {e}")
            try:
                validate_event(event)
            except ValueError as e:
                raise ValueError(f"{path}:{lineno}: {e}")
            n += 1
    if n == 0:
        raise ValueError(f"{path}: no events (telemetry export was empty)")
    return n


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m repro_torch.telemetry.schema FILE.jsonl ...",
              file=sys.stderr)
        return 2
    failed = False
    for path in argv:
        try:
            n = validate_jsonl(path)
            print(f"OK {path}: {n} events valid")
        except (OSError, ValueError) as e:
            failed = True
            print(f"INVALID {e}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
