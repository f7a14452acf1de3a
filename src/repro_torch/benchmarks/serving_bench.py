"""Serving bench: continuous batching vs serial one-at-a-time decode.

Offered-load sweep: the same request set (random prompt lengths, fixed
generation budget) is pushed through the ServingEngine at increasing slot
counts (concurrency = offered load, closed-loop: every request is queued
at t=0 and waits for a slot).  Reported per level: generated tokens/sec
and p50/p95 end-to-end request latency.  ``n_slots=1`` IS the serial
baseline — one request at a time through the identical prefill-chunk +
decode-step path — so the speedup column isolates the scheduler/batching
win from kernel effects.

Emits ``BENCH_serving_torch.json`` (``BENCH_serving.json``'s fields) and
the ``name,us_per_call,derived`` CSV rows (middle column = wall-µs per
generated token).  The clock stops after the card has synchronised.

``--smoke`` runs 8 requests through a 4-slot scheduler, asserts greedy
outputs are identical to the serial engine, and writes the deterministic
counters to ``BENCH_serving_smoke_torch.json``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import block_until_ready, emit
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving import SchedulerConfig, ServingEngine, latency_summary

TINY = ModelConfig(arch_id="serving-bench-tiny", n_layers=2, d_model=128,
                   n_heads=4, n_kv_heads=4, d_ff=256, vocab_size=512,
                   max_seq_len=512)
MAX_LEN = 128
GEN = 48


def make_requests(n, seed=0, lo=6, hi=17):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, TINY.vocab_size, rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def init_params(device=None):
    """TINY's weights from seed 0 on ``device`` (the card unless given)."""
    return get_model(TINY).init(0, TINY, device=resolve_device(device))


def run_level(params, prompts, n_slots, prefill_chunk=16, device=None):
    eng = ServingEngine(TINY, params=params, sched=SchedulerConfig(
        n_slots=n_slots, max_len=MAX_LEN, prefill_chunk=prefill_chunk,
        page_size=32), device=device)
    t0 = time.perf_counter()
    for p in prompts:
        eng.add_request(p, max_new_tokens=GEN)
    outs = eng.run()
    # barrier on the device-resident KV cache before stopping the clock
    block_until_ready(eng.device)
    wall = time.perf_counter() - t0
    tokens = sum(len(o.tokens) for o in outs)
    return {
        "n_slots": n_slots,
        "n_requests": len(prompts),
        "gen_tokens": tokens,
        "wall_s": round(wall, 3),
        "tokens_per_s": round(tokens / wall, 1),
        # TTFT/ITL/e2e percentiles from the shared telemetry helper
        "latency": latency_summary(outs),
        "engine_steps": eng.n_steps,
    }, outs


def smoke(out_json="BENCH_serving_smoke_torch.json", device=None):
    """8 requests through the 4-slot scheduler, greedy outputs identical to
    the serial engine.  Writes the deterministic counters (token and step
    counts, not wall-clock) -> the report dict."""
    params = init_params(device)
    prompts = make_requests(8)
    res_b, batched = run_level(params, prompts, n_slots=4, device=device)
    res_s, serial = run_level(params, prompts, n_slots=1, device=device)
    assert [o.tokens for o in batched] == [o.tokens for o in serial], \
        "batched greedy output diverged from serial"
    report = {
        "n_requests": len(prompts),
        "gen_tokens": res_b["gen_tokens"],
        "engine_steps_batched": res_b["engine_steps"],
        "engine_steps_serial": res_s["engine_steps"],
        "batched_equals_serial": True,
    }
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_json}")
    print(f"serving smoke OK: {len(prompts)} requests, "
          f"{sum(len(o.tokens) for o in batched)} tokens, "
          f"batched == serial")
    return report


def main(rows=None, n_requests=16, levels=(1, 2, 4, 8),
         out_json="BENCH_serving_torch.json", device=None):
    rows = rows if rows is not None else []
    params = init_params(device)
    prompts = make_requests(n_requests)
    results = []
    for n_slots in levels:
        run_level(params, prompts[:2], n_slots, device=device)   # warmup
        res, _ = run_level(params, prompts, n_slots, device=device)
        results.append(res)
        us_per_tok = res["wall_s"] / res["gen_tokens"] * 1e6
        lat = res["latency"]
        rows.append(emit(f"serving.slots{n_slots}.tokens_per_s", us_per_tok,
                         res["tokens_per_s"]))
        rows.append(emit(f"serving.slots{n_slots}.p50_p95_s", us_per_tok,
                         f"{lat['e2e_s']['p50']}/{lat['e2e_s']['p95']}"))
        rows.append(emit(f"serving.slots{n_slots}.ttft_itl_p50_s", us_per_tok,
                         f"{lat['ttft_s']['p50']}/{lat['itl_s']['p50']}"))
    base = results[0]["tokens_per_s"]
    peak = results[-1]["tokens_per_s"]
    speedup = peak / base
    rows.append(emit("serving.batch_vs_serial_speedup", 0,
                     f"{speedup:.2f}x"))
    report = {"model": TINY.arch_id, "max_len": MAX_LEN, "gen": GEN,
              "levels": results, "speedup_vs_serial": round(speedup, 2)}
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_json}")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="8 requests through the scheduler + identity "
                         "check vs serial")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--out", default=None,
                    help="JSON output path (default depends on mode)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    if args.smoke:
        smoke(out_json=args.out or "BENCH_serving_smoke_torch.json",
              device=args.device)
    else:
        main(n_requests=args.requests,
             out_json=args.out or "BENCH_serving_torch.json",
             device=args.device)
