"""Fleet-scale aggregation bench: flat vs two-tier hierarchical, K ∈
{10^3, 10^4, 10^5} simulated clients (DESIGN.md §Fleet; emits
BENCH_fleet_torch.json with ``BENCH_fleet.json``'s fields).

Substrate-level on purpose: no model training, just the round substrate
the fleet subsystem changes — a ``FleetScheduler`` cohort, a
``PagedClientStore`` EF gather/scatter per round, seeded synthetic
deltas, and the port's real ``weighted_mean`` reduction (the weighted
reduce kernel on the card) — so the K=10^5 cell costs seconds, not hours.
Per (fleet, mode) cell:

* **flat** stages the whole cohort's wires as one (C, d) block and runs
  one global ``weighted_mean`` — the O(C·d) server staging footprint.
* **hier** walks the cohort's regions sequentially: each regional block
  (k_r, d) is staged, reduced to a partial, and FREED before the next
  region is built; the global combine then reduces the (R, d) partial
  stack — exactly ``hierarchical_aggregate``'s split, so peak staging
  drops from O(C·d) to O((C/R)·d + R·d).

Peak staging bytes are ``numel() * element_size()`` of the live staged
tensors, plus the store's resident high-water mark: deterministic given the
seed (the deltas are drawn by ``np.random.RandomState`` as the reference
draws them, then moved to the device).  ``rounds_per_s`` is the one
wall-clock field; the clock stops after the card has synchronised.

``--smoke`` keeps all three K cells and only trims the round count; every
byte field is round-count invariant.
"""
import argparse
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import block_until_ready, emit
from repro_torch.configs.base import FedConfig
from repro_torch.device import resolve_device
from repro_torch.federated import aggregation as A
from repro_torch.federated.fleet import FleetScheduler, PagedClientStore
from repro_torch.telemetry import Counters

FLEETS = (1_000, 10_000, 100_000)
COHORT = 256
REGIONS = 8
DIM = 8192                      # 32 KiB fp32 page per client
BUDGET_PAGES = 64               # < COHORT pages -> steady-state spilling


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _run_mode(fleet: int, hierarchical: bool, rounds: int, seed: int = 0,
              device=None):
    """Drive `rounds` substrate rounds; returns the cell dict."""
    dev = resolve_device(device)
    d = DIM
    budget = BUDGET_PAGES * d * 4
    fed = FedConfig(n_clients=fleet, clients_per_round=COHORT,
                    fleet_regions=REGIONS if hierarchical else 0)
    counters = Counters()
    store = PagedClientStore(budget_bytes=budget, counters=counters)
    store.register("ef", lambda: torch.zeros((d,), dtype=torch.float32,
                                             device=dev))
    sched = FleetScheduler(fed, n_regions=REGIONS if hierarchical else 1,
                           seed=seed)
    rng = np.random.RandomState(seed)
    peak_staging = 0
    t0 = time.time()
    for _ in range(rounds):
        cohort = sched.sample_cohort()
        groups = (cohort.region_slices() if hierarchical
                  else ((0, len(cohort.clients)),))
        partials, gw = [], []
        for start, size in groups:
            ids = cohort.clients[start:start + size]
            efs = store.gather("ef", ids)                    # (size, d)
            deltas = torch.from_numpy(
                rng.randn(size, d).astype(np.float32)).to(dev)
            wires = deltas + efs
            w = torch.ones((size,), dtype=torch.float32, device=dev)
            m = A.weighted_mean(wires, w)
            block_until_ready(dev)
            staged = (_nbytes(efs) + _nbytes(deltas) + _nbytes(wires)
                      + sum(_nbytes(p) for p in partials))
            peak_staging = max(peak_staging, staged)
            partials.append(m)
            gw.append(torch.sum(w))
            store.scatter("ef", ids, wires * 0.5)            # EF update
            del efs, deltas, wires                           # free the block
        if hierarchical:                  # the global combine
            A.weighted_mean(torch.stack(partials), torch.stack(gw))
        block_until_ready(dev)
    wall = time.time() - t0
    snap = counters.snapshot()
    peak_store = int(store.peak_resident_bytes)
    return {
        "fleet": fleet,
        "mode": "hier" if hierarchical else "flat",
        "regions": REGIONS if hierarchical else 0,
        "cohort": COHORT,
        "d": d,
        "store_budget_bytes": budget,
        "peak_staging_bytes": int(peak_staging),
        "peak_store_bytes": peak_store,
        "peak_host_bytes": int(peak_staging) + peak_store,
        "budget_ok": bool(peak_store <= budget),
        "spills_per_round": round(snap.get("store.spills", 0) / rounds, 1),
        "loads_per_round": round(snap.get("store.loads", 0) / rounds, 1),
        "rounds_per_s": round(rounds / wall, 2),
    }


def main(rows=None, out_json="BENCH_fleet_torch.json", smoke=False,
         device=None):
    rows = rows if rows is not None else []
    rounds = 2 if smoke else 3
    cells = []
    for fleet in FLEETS:
        for hierarchical in (False, True):
            cell = _run_mode(fleet, hierarchical, rounds, device=device)
            cells.append(cell)
            rows.append(emit(
                f"fleet.K{fleet}.{cell['mode']}",
                1e6 / cell["rounds_per_s"],
                f"peak_host_mb={cell['peak_host_bytes'] / 2**20:.1f};"
                f"spills_per_round={cell['spills_per_round']}"))
    at_1e5 = {c["mode"]: c for c in cells if c["fleet"] == 100_000}
    report = {
        "cohort": COHORT,
        "regions": REGIONS,
        "d": DIM,
        "rounds_per_cell": rounds,
        "cells": cells,
        "headline": {
            "hier_le_flat_peak_at_1e5": bool(
                at_1e5["hier"]["peak_host_bytes"]
                <= at_1e5["flat"]["peak_host_bytes"]),
            "budget_ok_at_1e5": bool(at_1e5["hier"]["budget_ok"]
                                     and at_1e5["flat"]["budget_ok"]),
            "peak_host_hier_over_flat_at_1e5": round(
                at_1e5["hier"]["peak_host_bytes"]
                / at_1e5["flat"]["peak_host_bytes"], 4),
            "rounds_per_s_ratio_hier_vs_flat_at_1e5": round(
                at_1e5["hier"]["rounds_per_s"]
                / at_1e5["flat"]["rounds_per_s"], 3),
        },
    }
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_json}")
    assert report["headline"]["budget_ok_at_1e5"], (
        "paged store exceeded its resident-bytes budget at K=1e5")
    assert report["headline"]["hier_le_flat_peak_at_1e5"], (
        "hierarchical peak host bytes no longer <= flat at K=1e5")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="BENCH_fleet_torch.json")
    ap.add_argument("--smoke", action="store_true",
                    help="fewer rounds per cell; all K cells kept")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(out_json=args.out, smoke=args.smoke, device=args.device)
