"""Readings that set a cell's comparison limits (not part of a run).

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control 3] [--faults half] [--fault-seeds 3] --out <file.jsonl>

In one process, for each seed: the program's set-up rounds and readings
(as a run takes them), the plain reference's, and the gaps between them:
the lower readings.  On the first ``--control`` seeds also each of the
configuration's ``controls`` (the reference at a precision below the
configuration's) against the reference, and on the first ``--fault-seeds`` seeds the program with each
planted fault: the upper readings.  One JSON line a seed.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def gaps(prog, ref):
    """The compared numbers of ``bench.compare``, with the worst leaf of
    each norm comparison named."""
    from perfbench import bench
    values = {}
    for c in bench.compare(prog, ref, {"loss": 0, "grad": 0, "change": 0}):
        values[c["name"]] = c["value"]
        if "leaf" in c:
            values[f"{c['name']}_leaf"] = c["leaf"]
    return values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    import torch
    from perfbench import bench, manifest
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    t = time.perf_counter()
    build.build_all()
    print(f"calibrate: the kernels' build {time.perf_counter() - t:.1f} s",
          file=sys.stderr)
    cell = manifest.cell(ROOT, args.workload)
    Engine = manifest.module(cell.bench, "engines",
                             cell.config["engine"]).Engine
    n = int(cell.config["check_rounds"])
    tf32 = cell.config["precision"]["tf32"]
    faults = [f for f in args.faults.split(",") if f]

    def program(seed, fault=None):
        torch.backends.cuda.matmul.allow_tf32 = tf32["matmul"]
        torch.backends.cudnn.allow_tf32 = tf32["cudnn"]
        e = Engine(cell, seed, "cuda", fault=fault)
        e.setup()
        prog = bench.program_readings(e, n, [])
        e.free()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return e, prog

    def reference(e, control=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        out = e.reference(n, control=control)
        torch.cuda.empty_cache()
        return out
    with open(args.out, "a") as f:
        for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            e, prog = program(seed)
            t1 = time.perf_counter()
            ref = reference(e)
            t2 = time.perf_counter()
            line = {"workload": args.workload, "seed": seed,
                    "program": gaps(prog, ref),
                    "loss_program": prog["loss"], "loss_reference":
                    ref["loss"], "program_s": t1 - t0, "reference_s": t2 - t1}
            if i < args.control:
                for name in cell.config["controls"]:
                    line[f"control_{name}"] = gaps(
                        reference(e, control=name), ref)
            if i < args.fault_seeds:
                for fault in faults:
                    line[f"fault_{fault}"] = gaps(program(seed, fault)[1],
                                                  ref)
            line["seconds"] = time.perf_counter() - t0
            f.write(json.dumps(line) + "\n")
            f.flush()
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
