"""Telemetry overhead bench (counterpart of ``benchmarks/telemetry_bench.py``):
the ≤5% contract, measured.

Runs the same synchronous FedADC configuration twice — telemetry disabled
(the default) and enabled with the drift diagnostics and span tracing — and
compares wall-clock per round after a shared warm-up.  The enabled run pays
a few dozen extra ATen calls a round for the diagnostics, one
device-to-host transfer of their scalars, and a wait for the card at the
end of each round's span; the bench asserts that the overhead stays within
the 5% budget and writes ``BENCH_telemetry_torch.json``
(``overhead_le_5pct`` the boolean, the raw ratio beside it).

It also checks the contract's other half: the enabled and disabled runs
must reach identical final accuracy — observability must not touch the
numerics.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.benchmarks.common import (block_until_ready, dataset, emit,
                                           partitions, run_fl)
from repro_torch.telemetry import Telemetry

MAX_OVERHEAD = 0.05


def _timed_run(parts, data, rounds, warmup, telemetry, device=None):
    # one throwaway run first: the kernels' build and the card's warm-up
    # (cuDNN's algorithm search) land outside the timed run
    run_fl("fedadc", parts, data, rounds=warmup, n_clients=20, seed=0,
           telemetry=Telemetry(engine="sim") if telemetry else None,
           device=device)
    t0 = time.perf_counter()
    r = run_fl("fedadc", parts, data, rounds=rounds, n_clients=20, seed=0,
               telemetry=Telemetry(engine="sim") if telemetry else None,
               device=device)
    block_until_ready(r["sim"].device)    # barrier before stopping the clock
    return time.perf_counter() - t0, r


def main(rows=None, rounds=40, warmup=4, out_json="BENCH_telemetry_torch.json",
         device=None):
    rows = rows if rows is not None else []
    data = dataset()
    parts = partitions(data[1], 20, "sort", 2, seed=0)
    wall_off, r_off = _timed_run(parts, data, rounds, warmup, False, device)
    wall_on, r_on = _timed_run(parts, data, rounds, warmup, True, device)
    ratio = wall_on / wall_off
    overhead = ratio - 1.0
    rows.append(emit("telemetry.sync_round_overhead",
                     wall_on / rounds * 1e6, f"{overhead:+.2%}"))
    identical = bool(r_on["acc"] == r_off["acc"])
    rows.append(emit("telemetry.enabled_acc_identical", 0, identical))
    report = {
        "rounds": rounds,
        "wall_ratio_on_vs_off": round(ratio, 4),
        "overhead_le_5pct": bool(overhead <= MAX_OVERHEAD),
        "enabled_acc_identical": identical,
    }
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_json}")
    assert identical, "telemetry-enabled run changed the accuracy"
    assert overhead <= MAX_OVERHEAD, (
        f"telemetry overhead {overhead:+.2%} exceeds the documented "
        f"{MAX_OVERHEAD:.0%} budget")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=40)
    ap.add_argument("--out", default="BENCH_telemetry_torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(rounds=args.rounds, out_json=args.out, device=args.device)
