"""Benchmark harness of the port — one module per paper table/figure.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.run
          [--only fig1_acceleration,clustering] [--device cpu]

It runs on the GPU unless ``--device cpu`` is given, and fails without a
card otherwise.  Prints ``name,us_per_call,derived`` CSV.  Modules:
  fig1_acceleration  — Fig. 1 a-c  (FedADC vs FedAvg vs SlowMo, s=2,3,4)
  fig2_robustness    — Fig. 2      (FedADC robustness to skew; red vs blue)
  ablation_beta      — Sec. II     (β sweep; β_local ∈ {0, β/2, β})
  clustering         — Sec. IV-E   (class-coverage client selection)
  table1_sota        — Table I     (vs MOON/FedGKD/FedNTD/FedDyn/FedProx/
                                     SCAFFOLD/FedRS, 2 regimes)
  fig5_scale         — Fig. 5/6    (low participation, many clients)
  fig7_personalization — Fig. 7    (classifier calibration, 3 regularisers)
  straggler_bench    — wall-clock-to-accuracy, sync vs semi-async FedADC
                       under a 4× straggler fleet
  fleet_bench        — flat vs two-tier hierarchical aggregation at
                       K ∈ {1e3,1e4,1e5} simulated clients (emits
                       BENCH_fleet_torch.json)
  comm_load          — Sec. II-A   analytic bytes/round per strategy, side by
                       side with measured per-client wire bytes through each
                       compressor
  serving_bench      — continuous batching vs serial decode: offered-load
                       sweep, tokens/sec + p50/p95 latency (emits
                       BENCH_serving_torch.json)
  comm_sweep         — accuracy-vs-bytes frontier: strategy x uplink codec,
                       the async compression x staleness axis, intermittent
                       participation, the downlink codecs, with drift
                       curves (emits BENCH_comm_torch.json)
  telemetry_bench    — telemetry on vs off overhead, the <=5% contract
                       (emits BENCH_telemetry_torch.json)

Run only when named (``--only lm_round``; ``chip_smoke.py`` phase 15 runs
it, phase 12 the modules above):
  lm_round           — FedADC vs FedAvg on federated LM fine-tuning through
                       the pod engine (held-out loss, µs a round)

Not ported yet (``--only`` with one of these names exits non-zero):
  roofline_report    — roofline terms from the dry-run artifacts (item 19a)
  kernels_bench      — kernels µs/call + derived bytes/flops (item 21)
"""
import argparse
import importlib
import sys
import time

from repro_torch.benchmarks.common import block_until_ready
from repro_torch.device import resolve_device

MODULES = ("fig1_acceleration", "fig2_robustness", "ablation_beta",
           "clustering", "table1_sota", "fig5_scale", "fig7_personalization",
           "straggler_bench", "fleet_bench", "comm_load", "serving_bench",
           "comm_sweep", "telemetry_bench")
ON_REQUEST = ("lm_round",)
UNPORTED = {
    "roofline_report": "ROADMAP Queue 1 item 19a",
    "kernels_bench": "ROADMAP Queue 1 item 21",
}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", default=None,
                    help="comma-separated benchmark names")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    picked = args.only.split(",") if args.only else list(MODULES)
    for name in picked:
        if name in UNPORTED:
            print(f"{name} is not ported to the PyTorch port yet "
                  f"({UNPORTED[name]})", file=sys.stderr)
            return 2
        if name not in MODULES + ON_REQUEST:
            print(f"unknown benchmark {name!r}; known: "
                  f"{', '.join(MODULES + ON_REQUEST)}", file=sys.stderr)
            return 2
    # no silent fallback: without a card this raises unless --device cpu
    device = resolve_device(args.device)

    print("name,us_per_call,derived")
    rows, failed = [], []
    for name in picked:
        t0 = time.time()
        print(f"# --- {name} ---", flush=True)
        try:
            importlib.import_module(f"repro_torch.benchmarks.{name}").main(
                rows, device=str(device))
        except Exception as e:  # keep the harness going; the exit code says
            print(f"{name},0,ERROR:{e!r}", flush=True)
            failed.append(name)
        block_until_ready(device)
        print(f"# {name} took {time.time()-t0:.1f}s", flush=True)
    print(f"# total rows: {len(rows)}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
