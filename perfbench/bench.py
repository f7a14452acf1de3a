"""One run of one cell: set-up, the measured window, the traced
sub-window, the comparison with the plain reference, and the result.

1. Set-up (``setup_s``, from the process's start, the kernels' build
   left out): the engine builds the program's round (weights made on the
   device from the seed, traffic from the seed) and drives it through
   ``check_rounds`` rounds on rows that all differ, through the same call
   as the window.  After the first it reads the first gradient per leaf
   as the server's optimizer has it (where, the mix's round reference
   says), after the last the parameters' change per leaf; and each
   round's loss.
2. The window: whole rounds until ``--seconds`` have passed, then
   ``torch.cuda.synchronize()``; ``round_s`` is its wall time over its
   rounds, ``peak_mem_gib`` the allocator's peak in it.
3. With ``--trace 1``: ``profile_rounds`` more rounds under the profiler.
4. The program's state is freed; the mix's plain round reference follows
   the same ``check_rounds`` rounds from the same weights and batches,
   and each number compared is held to its limit
   (``limits/<workload>.json``).
"""
from __future__ import annotations

import collections
import json
import statistics
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from perfbench import manifest
from perfbench.trace import Spans, Trace, breakdown, capture
from perfbench.yardstick.peaks import peaks_for

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
PEAK_KEYS = ("allocated_bytes", "requested_bytes", "reserved_bytes")


def round_peaks(torch):
    """The allocator's peaks since the last call, then reset."""
    st = torch.cuda.memory_stats()
    torch.cuda.reset_peak_memory_stats()
    return tuple(st.get(k + ".all.peak", 0) for k in PEAK_KEYS)


@dataclass
class Context:
    """What a metric's ``read(ctx)`` reads."""
    cell: manifest.Cell
    engine: object
    setup_s: float
    window: Dict
    trace: Optional[Trace]
    peaks: object

    def metric_module(self, name: str):
        return manifest.module(self.cell.bench, "metrics", name)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], keep):
    """-> (max over the kept leaves of |‖p‖ − ‖r‖| / max(‖r‖, median
    ‖r‖), the leaf that gives it)."""
    med = statistics.median(ref.values())
    return max((abs(prog[k] - ref[k]) / max(ref[k], med), k) for k in keep)


def compare(prog: Dict, ref: Dict, limits: Dict) -> List[Dict]:
    """The numbers compared, each with its limit (and, for the norms, the
    worst leaf).  Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of the gradient and the change (they
    move by rounding alone)."""
    med = statistics.median(ref["grad"].values())
    keep = [k for k, v in ref["grad"].items() if v >= 1e-3 * med]
    out = [{"name": "loss", "value": max(
        abs(p - r) / abs(r) for p, r in zip(prog["loss"], ref["loss"]))}]
    for key in ("grad", "change"):
        value, leaf = worst_leaf(prog[key], ref[key], keep)
        out.append({"name": key, "value": value, "leaf": leaf})
    return [{**c, "limit": limits[c["name"]]} for c in out]


def program_readings(engine, rounds: int, log: List[str]) -> Dict:
    """Drive the engine's first ``rounds`` rounds -> each round's loss,
    the first gradient's per-leaf norms as the server's optimizer has it
    after the first, and the parameters' per-leaf change after the last."""
    prog = {"loss": []}
    for r in range(rounds):
        t = time.perf_counter()
        engine.step(r, None)
        prog["loss"].append(engine.loss())
        if r == 0:
            prog["grad"] = engine.gradient_norms()
        log.append(f"set-up round {r}: {time.perf_counter() - t:.3f} s")
    prog["change"] = engine.change_norms()
    return prog


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def run_cell(root, workload: str, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", fault: Optional[str] = None,
             bench=manifest.HERE, reference: str = "plain") -> Dict:
    """-> {"result": the result line's dict, "checks": [...], "log":
    [...]}.  ``fault`` plants a fault in the program's round (tests and
    calibration); ``reference`` names one of the configuration's
    ``controls`` (``"control"``: the first), run at its lower precision in
    the program's place."""
    import torch
    cell = manifest.cell(root, workload, bench)
    cfg = cell.config
    on_card = device == "cuda"
    tf32 = cfg["precision"]["tf32"]
    torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
    torch.backends.cudnn.allow_tf32 = tf32["cudnn"]
    Engine = manifest.module(cell.bench, "engines", cfg["engine"]).Engine
    engine = Engine(cell, seed, device, fault=fault)

    def sync():
        if on_card:
            torch.cuda.synchronize()
    log = []
    t = time.perf_counter()
    engine.setup()
    log.append(f"set-up: program, weights and traffic in "
               f"{time.perf_counter() - t:.3f} s "
               f"({t - t_start:.3f} s after the process's start): "
               + ", ".join(f"{k} {v:.3f} s" for k, v in
                           getattr(engine, "times", {}).items()))
    n_check = int(cfg["check_rounds"])
    prog = program_readings(engine, n_check, log)
    sync()
    setup_s = time.perf_counter() - t_start

    spans = Spans()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    # each round's allocator peaks (host-side counts, no sync), so that a
    # run whose peak differs shows which rounds it came from
    peaks = []
    sync()
    t0 = time.perf_counter()
    r = n_check
    while True:
        engine.step(r, spans)
        r += 1
        if on_card:
            peaks.append(round_peaks(torch))
        if time.perf_counter() - t0 >= seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    rounds = r - n_check
    if on_card:
        peaks.append(round_peaks(torch))
        top = [max(p[i] for p in peaks) for i in range(len(PEAK_KEYS))]
        log.append("window memory peaks: " + ", ".join(
            f"{k} {v}" for k, v in zip(PEAK_KEYS, top)))
        log.append("rounds by allocated peak: " + ", ".join(
            f"{v} x{n}" for v, n in sorted(collections.Counter(
                p[0] for p in peaks[:-1]).items())))
    peak = top[0] if on_card else 0
    for name in ("stage", "engine"):
        per = [round((e - s_) / 1e6, 3) for n, s_, e in spans.records
               if n == name]
        if per:
            log.append(f"window {name} ms a round: {per}")
    window = {"rounds": rounds, "seconds": window_s, "peak_bytes": peak,
              "host_ms": spans.total_ms("engine"),
              "stage_ms": spans.total_ms("stage")}
    tr = None
    if trace and on_card:
        k = int(cfg["profile_rounds"])
        tr = capture(torch, lambda i: engine.step(i, spans), r, k, spans)
        r += k
    engine.free()
    sync()
    if on_card:
        torch.cuda.empty_cache()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_ref = time.perf_counter()
    ref = engine.reference(n_check)
    if reference != "plain":
        name = next(iter(cfg["controls"])) if reference == "control" \
            else reference
        prog = engine.reference(n_check, control=name)
    ref_s = time.perf_counter() - t_ref
    log.append(f"losses: program {prog['loss']}, reference {ref['loss']}")
    checks = compare(prog, ref, cell.limits)
    correct = all(c["value"] <= c["limit"] for c in checks)
    log.append(f"reference: {n_check} rounds in {ref_s:.1f} s; window "
               f"{window_s:.3f} s, {rounds} rounds")

    card = torch.cuda.get_device_name(0) if on_card else "cpu"
    peaks = peaks_for(card)
    ctx = Context(cell, engine, setup_s, window, tr, peaks)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = ctx.metric_module(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": card,
           "count": cell.chips,
           "memory_peak_bytes": peak}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
    result = {"correct": correct, "attempted": rounds, "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = breakdown(tr)
        log.append(f"trace: {len(tr.events)} device ops in "
                   f"{tr.window_s:.3f} s over {tr.rounds} rounds, placed by "
                   f"the {tr.aligned_by}")
    result["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                        for c in checks}
    return {"result": result, "checks": checks, "log": log,
            "readings": {"program": prog, "reference": ref}}


def emit(out: Dict) -> None:
    """The log and the checks on standard error (the checks last), the
    result as the last line of standard output."""
    for line in out["log"]:
        print(line, file=sys.stderr)
    for c in out["checks"]:
        leaf = f"; worst leaf {c['leaf']}" if "leaf" in c else ""
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}"
              f"{leaf})", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
