"""Accuracy-vs-bytes frontier, the measured version of Sec. II-A
(counterpart of ``benchmarks/comm_sweep.py``).

Three sweeps on the synthetic non-IID benchmark (sorted 2-class shards, the
paper's hardest skew):

* **sync** — strategy × uplink codec on the synchronous simulator: final
  accuracy against the *measured* bytes the transport wire formats actually
  carry, in both directions (downlink is the real (θ_t, ctx) broadcast
  tree, measured — not the analytic n·4·clients floor).
* **async** — the ROADMAP-requested ``topk_frac``/``qsgd_bits`` ×
  staleness axis on the semi-async engine: each compression knob runs under
  a bimodal straggler fleet with buffered-K aggregation, with and without
  staleness discounting, so the frontier shows how lossy uplinks compose
  with stale pseudo-gradients (EF mass is conserved across drops).
* **downlink** — the downlink frontier: FedADC under the per-direction
  downlink codecs, headlined by the momentum-aware Δm̄ reference-coded
  broadcast (``delta``), which drives measured downlink from the naive 2×
  raw θ (the wire tree carries m̄_t) to ~1× — the paper's overlapped
  broadcast, now measured — while staying bit-lossless; ``delta+topk`` /
  ``delta+qsgd`` push below 1× by compressing the θ-delta itself.

Headline check (asserted into the JSON, gated in CI): top-k 10% with error
feedback stays within 2 accuracy points of the uncompressed FedADC run
while shrinking measured uplink bytes ≥ 5×.

Writes ``BENCH_comm_torch.json`` (``BENCH_comm.json``'s layout) plus the
repo-standard CSV rows.  Its byte fields depend only on the seed, the grid
and the wire sizes, so at the default rounds they equal the committed
``BENCH_comm.json``'s; the accuracies come from the device's arithmetic.
``--rounds`` scales the sweep up for real frontier plots.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import (HeteroConfig, dataset, emit,
                                           partitions, run_fl, run_fl_async)
from repro_torch.telemetry import Telemetry

STRATEGIES = ("fedavg", "slowmo", "fedadc")
COMPRESSORS = (
    ("none", {"compressor": "none"}),
    ("topk10_ef", {"compressor": "topk", "topk_frac": 0.10,
                   "error_feedback": True}),
    ("qsgd4_ef", {"compressor": "qsgd", "qsgd_bits": 4,
                  "error_feedback": True}),
)

# async axis: compression knobs × staleness handling, under stragglers
ASYNC_KNOBS = (
    ("topk5_ef", {"compressor": "topk", "topk_frac": 0.05,
                  "error_feedback": True}),
    ("topk20_ef", {"compressor": "topk", "topk_frac": 0.20,
                   "error_feedback": True}),
    ("qsgd2_ef", {"compressor": "qsgd", "qsgd_bits": 2,
                  "error_feedback": True}),
    ("qsgd8_ef", {"compressor": "qsgd", "qsgd_bits": 8,
                  "error_feedback": True}),
)
ASYNC_STALENESS = (
    ("stale_none", {"buffer_k": 2, "staleness_mode": "none"}),
    ("stale_poly", {"buffer_k": 2, "staleness_mode": "poly",
                    "staleness_factor": 0.5}),
)
ASYNC_HETERO = HeteroConfig(enabled=True, speed_dist="bimodal",
                            straggler_frac=0.25, straggler_slowdown=4.0,
                            seed=0)

# downlink frontier: FedADC × per-direction downlink codecs.  The
# "down_none" baseline is not re-run: it is the sync sweep's
# ("fedadc", "none") cell (byte-for-byte the same configuration), reused
# in main() instead of duplicating the longest 90-round run.
DOWNLINK_KNOBS = (
    ("down_delta", {"downlink_compressor": "delta"}),
    ("down_delta_topk10", {"downlink_compressor": "delta+topk",
                           "downlink_topk_frac": 0.10}),
    ("down_delta_qsgd8", {"downlink_compressor": "delta+qsgd",
                          "downlink_qsgd_bits": 8}),
)

# intermittent participation × catch-up horizon: the unicast downlink under
# clients that miss rounds (HeteroConfig availability thinning on the async
# engine).  The horizon is accounting-only — the trajectory is identical
# across it — but the bytes are not: staleness ≤ horizon rides the cheap
# chained θ-delta, horizon 0 degenerates to a full-θ resync per revisit.
INTERMITTENT_GRID = tuple((av, h) for av in (1.0, 0.5) for h in (0, 4))


def _cell(name_kv, r):
    s = r["sim"]
    cell = dict(name_kv)
    cell.update({
        "acc": round(r["acc"], 4),
        "uplink_bytes": int(s.uplink_bytes),
        "uplink_bytes_raw": int(s.uplink_bytes_raw),
        "downlink_bytes": int(s.downlink_bytes),
        "downlink_bytes_raw": int(s.downlink_bytes_raw),
        "bytes_reduction": round(s.uplink_bytes_raw / s.uplink_bytes, 2),
        "us_per_round": r["us_per_round"],
    })
    return cell


def _drift_cell(tel: Telemetry):
    """First/last points of each per-round drift metric — the curve's
    endpoints are the deterministic, tolerance-friendly summary the CI
    gate can diff (the full curve rides the JSONL export, not the bench
    JSON)."""
    dc = list(tel.drift_curve)
    first, last = dc[0], dc[-1]
    out = {}
    for k in sorted(last):
        if k == "round":
            continue
        out[f"{k}_first"] = round(float(first.get(k, last[k])), 5)
        out[f"{k}_last"] = round(float(last[k]), 5)
    out["rounds_recorded"] = len(dc)
    return out


def sweep(rounds=90, n_clients=20, seed=0, device=None):
    data = dataset()
    parts = partitions(data[1], n_clients, "sort", 2, seed=seed)
    cells, drift = [], {}
    for strat in STRATEGIES:
        for cname, extra in COMPRESSORS:
            tel = Telemetry(engine="sim")
            r = run_fl(strat, parts, data, rounds=rounds,
                       n_clients=n_clients, seed=seed, extra_fed=extra,
                       telemetry=tel, device=device)
            cells.append(_cell({"strategy": strat, "compressor": cname}, r))
            drift[f"{strat}_{cname}"] = _drift_cell(tel)
    return cells, drift


def _down_ratio(cell):
    # measured broadcast bytes against the raw θ a client uploads — the
    # paper's "no additional communication load" axis
    return round(cell["downlink_bytes"] / cell["uplink_bytes_raw"], 3)


def downlink_sweep(base_cell, rounds=90, n_clients=20, seed=0,
                   device=None):
    """FedADC downlink frontier.  `base_cell` is the sync sweep's
    ("fedadc", "none") cell, reused as the "down_none" baseline."""
    data = dataset()
    parts = partitions(data[1], n_clients, "sort", 2, seed=seed)
    down_none = dict(base_cell, downlink="down_none",
                     downlink_vs_uplink_raw=_down_ratio(base_cell))
    down_none.pop("compressor", None)
    cells = [down_none]
    for dname, extra in DOWNLINK_KNOBS:
        r = run_fl("fedadc", parts, data, rounds=rounds,
                   n_clients=n_clients, seed=seed, extra_fed=extra,
                   device=device)
        cell = _cell({"strategy": "fedadc", "downlink": dname}, r)
        cell["downlink_vs_uplink_raw"] = _down_ratio(cell)
        cells.append(cell)
    return cells


def async_sweep(rounds=80, n_clients=20, seed=0, device=None):
    data = dataset()
    parts = partitions(data[1], n_clients, "sort", 2, seed=seed)
    cells, drift = [], {}
    for cname, comp in ASYNC_KNOBS:
        for sname, stale in ASYNC_STALENESS:
            extra = dict(comp)
            extra.update(stale)
            tel = Telemetry(engine="async")
            r = run_fl_async("fedadc", parts, data, hetero=ASYNC_HETERO,
                             rounds=rounds, n_clients=n_clients, seed=seed,
                             extra_fed=extra, telemetry=tel, device=device)
            cell = _cell({"compressor": cname, "staleness": sname}, r)
            cell["mean_staleness"] = round(r["sim"].staleness_hist.mean(), 3)
            cells.append(cell)
            drift[f"async_{cname}_{sname}"] = _drift_cell(tel)
    return cells, drift


def intermittent_sweep(rounds=40, n_clients=20, seed=0, device=None):
    """FedADC + lossless delta + unicast on the async engine over the
    availability × resync_horizon grid, with the per-class byte totals the
    CI gate pins."""
    data = dataset()
    parts = partitions(data[1], n_clients, "sort", 2, seed=seed)
    cells = []
    for av, h in INTERMITTENT_GRID:
        het = HeteroConfig(enabled=True, speed_dist="bimodal",
                           straggler_frac=0.25, straggler_slowdown=4.0,
                           availability=av, seed=0)
        extra = {"downlink_compressor": "delta", "downlink_unicast": True,
                 "resync_horizon": h, "buffer_k": 2}
        r = run_fl_async("fedadc", parts, data, hetero=het, rounds=rounds,
                         n_clients=n_clients, seed=seed, extra_fed=extra,
                         device=device)
        s = r["sim"]
        t = s.transport
        n_catchup, n_resync = int(s.refs.catchups), int(s.refs.resyncs)
        cells.append({
            "availability": av, "resync_horizon": h,
            "acc": round(r["acc"], 4),
            "downlink_bytes": int(s.downlink_bytes),
            "downlink_bytes_raw": int(s.downlink_bytes_raw),
            "catchups": n_catchup, "resyncs": n_resync,
            "catchup_bytes": int(n_catchup * t._down_nbytes),
            "resync_bytes": int(n_resync * t._down_raw),
            "us_per_round": r["us_per_round"],
        })
    return cells


def main(rows=None, rounds=90, async_rounds=80, intermittent_rounds=40,
         out_json="BENCH_comm_torch.json", device=None):
    rows = rows if rows is not None else []
    cells, drift = sweep(rounds=rounds, device=device)
    by = {(c["strategy"], c["compressor"]): c for c in cells}
    for c in cells:
        rows.append(emit(
            f"comm_sweep.{c['strategy']}.{c['compressor']}",
            c["us_per_round"],
            f"acc={c['acc']};up_MB={c['uplink_bytes']/2**20:.2f};"
            f"down_MB={c['downlink_bytes']/2**20:.2f};"
            f"reduction={c['bytes_reduction']:.2f}x"))
    async_cells, async_drift = async_sweep(rounds=async_rounds,
                                           device=device)
    drift.update(async_drift)
    for c in async_cells:
        rows.append(emit(
            f"comm_sweep.async.fedadc.{c['compressor']}.{c['staleness']}",
            c["us_per_round"],
            f"acc={c['acc']};up_MB={c['uplink_bytes']/2**20:.2f};"
            f"stale={c['mean_staleness']:.2f};"
            f"reduction={c['bytes_reduction']:.2f}x"))
    intermittent_cells = intermittent_sweep(rounds=intermittent_rounds,
                                            device=device)
    for c in intermittent_cells:
        rows.append(emit(
            f"comm_sweep.intermittent.av{c['availability']}"
            f".h{c['resync_horizon']}", c["us_per_round"],
            f"acc={c['acc']};down_MB={c['downlink_bytes']/2**20:.2f};"
            f"catchups={c['catchups']};resyncs={c['resyncs']}"))
    downlink_cells = downlink_sweep(by[("fedadc", "none")], rounds=rounds,
                                    device=device)
    for c in downlink_cells:
        rows.append(emit(
            f"comm_sweep.downlink.fedadc.{c['downlink']}",
            c["us_per_round"],
            f"acc={c['acc']};down_MB={c['downlink_bytes']/2**20:.2f};"
            f"down_vs_up_raw={c['downlink_vs_uplink_raw']:.3f}x"))
    d = drift["fedadc_none"]
    rows.append(emit(
        "comm_sweep.drift.fedadc_none", 0,
        f"disp_last={d['delta_dispersion_last']};"
        f"align_last={d['momentum_alignment_last']};"
        f"norm_last={d['update_norm_last']}"))
    base = by[("fedadc", "none")]
    topk = by[("fedadc", "topk10_ef")]
    acc_gap = base["acc"] - topk["acc"]
    reduction = topk["bytes_reduction"]
    rows.append(emit("comm_sweep.fedadc_topk10_vs_uncompressed", 0,
                     f"acc_gap={acc_gap:.4f};bytes_reduction={reduction:.2f}x"))
    down_by = {c["downlink"]: c for c in downlink_cells}
    d_none, d_delta = down_by["down_none"], down_by["down_delta"]
    delta_ratio = d_delta["downlink_vs_uplink_raw"]
    rows.append(emit(
        "comm_sweep.fedadc_delta_downlink_vs_naive", 0,
        f"delta={delta_ratio:.3f}x;naive="
        f"{d_none['downlink_vs_uplink_raw']:.3f}x;"
        f"lossless_acc_equal={d_delta['acc'] == d_none['acc']}"))
    inter = {(c["availability"], c["resync_horizon"]): c
             for c in intermittent_cells}
    i_h4, i_h0 = inter[(0.5, 4)], inter[(0.5, 0)]
    rows.append(emit(
        "comm_sweep.unicast_catchup_vs_resync", 0,
        f"h4_MB={i_h4['downlink_bytes']/2**20:.2f};"
        f"h0_MB={i_h0['downlink_bytes']/2**20:.2f};"
        f"catchup_lt_resync={i_h4['downlink_bytes'] < i_h0['downlink_bytes']};"
        f"acc_equal={i_h4['acc'] == i_h0['acc']}"))
    report = {
        "benchmark": "synthetic non-IID (sorted 2-class shards)",
        "rounds": rounds,
        "async_rounds": async_rounds,
        "intermittent_rounds": intermittent_rounds,
        "cells": cells,
        "async_cells": async_cells,
        "downlink_cells": downlink_cells,
        "intermittent_cells": intermittent_cells,
        # per-round drift diagnostics (curve endpoints; underscore keys so
        # a gate can address them as dotted paths)
        "drift": drift,
        "headline": {
            "fedadc_acc_uncompressed": base["acc"],
            "fedadc_acc_topk10_ef": topk["acc"],
            "acc_gap": round(acc_gap, 4),
            "bytes_reduction": reduction,
            "within_2pts": bool(acc_gap <= 0.02),
            "reduction_ge_5x": bool(reduction >= 5.0),
            # measured (not analytic) downlink: FedADC's naive broadcast
            # carries m̄_t, so its wire tree is 2× the parameter bytes ...
            "fedadc_downlink_vs_uplink_raw": round(
                base["downlink_bytes_raw"] / base["uplink_bytes_raw"], 2),
            "downlink_measured": True,
            # ... and the momentum-aware Δm̄ reference-coded broadcast
            # recovers the paper's overlapped ~1× (round 0 pays the full
            # initial sync; every later round ships θ-delta bytes with the
            # derived ctx at 0), bit-lossless vs the plain broadcast
            "fedadc_downlink_delta_vs_uplink_raw": delta_ratio,
            "downlink_delta_le_1p1": bool(delta_ratio <= 1.1),
            "downlink_delta_lossless": bool(
                d_delta["acc"] == d_none["acc"]),
            # intermittent participation: catch-up deltas within the
            # horizon are strictly cheaper than per-revisit full-θ resyncs
            # for the same (accounting-invariant) trajectory
            "unicast_catchup_lt_resync": bool(
                i_h4["downlink_bytes"] < i_h0["downlink_bytes"]
                and i_h4["acc"] == i_h0["acc"]),
        },
    }
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_json}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="pin the committed-JSON configuration (90 sync / "
                         "80 async / 40 intermittent rounds) regardless of "
                         "--rounds")
    ap.add_argument("--rounds", type=int, default=90)
    ap.add_argument("--async-rounds", type=int, default=80)
    ap.add_argument("--intermittent-rounds", type=int, default=40)
    ap.add_argument("--out", default="BENCH_comm_torch.json")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(rounds=90 if args.smoke else args.rounds,
         async_rounds=80 if args.smoke else args.async_rounds,
         intermittent_rounds=40 if args.smoke
         else args.intermittent_rounds,
         out_json=args.out, device=args.device)
