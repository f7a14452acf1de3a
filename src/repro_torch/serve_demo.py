"""Serve a reduced architecture with batched requests (the port's
counterpart of the JAX package's ``examples/serve_demo.py``): prefill a
batch of prompts, then decode with the single-token serve step against the
KV/state cache.  Every architecture of ``configs/`` serves this way
(``--arch``); the encoder-decoder (whisper-small) decodes against cross
K/V that no encoder filled, as the reference's demo does.

``--engine`` instead routes the requests through the continuous-batching
``ServingEngine`` (chunked prefill interleaved with batched decode,
per-request sampling).  The engine refuses the encoder-decoder model, as
the reference's does: Whisper's cache has one position for the batch.

Run on the card:  PYTHONPATH=src python -m repro_torch.serve_demo
                      [--arch zamba2-1.2b] [--engine] [--device cpu]
                      [--telemetry-jsonl out.jsonl]  (with --engine only)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.device import resolve_device
from repro_torch.models.registry import get_model
from repro_torch.serving import (SamplingParams, SchedulerConfig,
                                 ServingEngine, latency_summary)
from repro_torch.telemetry import Telemetry


def run_engine(cfg, args, device):
    tel = Telemetry(jsonl=args.telemetry_jsonl, engine="serving") \
        if args.telemetry_jsonl else None
    eng = ServingEngine(cfg, sched=SchedulerConfig(
        n_slots=args.batch, max_len=args.prompt_len + args.gen,
        prefill_chunk=16), telemetry=tel, device=device)
    rng = np.random.RandomState(0)
    t0 = time.time()
    for i in range(2 * args.batch):          # oversubscribe the slots
        prompt = rng.randint(0, cfg.vocab_size, args.prompt_len).tolist()
        eng.add_request(prompt, max_new_tokens=args.gen,
                        sampling=SamplingParams(temperature=0.8, top_k=40,
                                                seed=i))
    outs = eng.run()
    dt = time.time() - t0
    toks = sum(len(o.tokens) for o in outs)
    lat = latency_summary(outs)
    print(f"{args.arch}-reduced engine on {device}: {len(outs)} requests "
          f"over {args.batch} slots, {toks} tokens in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s, p50 e2e {lat['e2e_s']['p50']:.2f}s, "
          f"p50 TTFT {lat['ttft_s']['p50']:.2f}s); "
          f"sample row: {outs[0].tokens[:16]}")
    if tel is not None:
        tel.close()
        print(f"telemetry events written to {args.telemetry_jsonl}")
    return outs


def run_batch(cfg, args, device):
    """Prefill by incremental decode (uniform across attention, MLA and
    recurrent caches), then greedy decode."""
    model = get_model(cfg)
    params = model.init(0, cfg, device=device)
    B, P, G = args.batch, args.prompt_len, args.gen
    rng = np.random.RandomState(0)
    prompts = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, P))).to(
        device)
    cache = model.init_cache(cfg, B, P + G, torch.float32, device=device)
    t0 = time.time()
    logits = None
    for t in range(P):
        logits, cache = model.decode_step(params, cache, prompts[:, t:t + 1],
                                          t, cfg)
    print(f"{args.arch}-reduced on {device}: prefill {P} tokens x {B} seqs "
          f"in {time.time() - t0:.2f}s")
    tok = torch.argmax(logits, -1)[:, None]
    out = [tok]
    t0 = time.time()
    for t in range(P, P + G):
        logits, cache = model.decode_step(params, cache, tok, t, cfg)
        tok = torch.argmax(logits, -1)[:, None]
        out.append(tok)
    gen = torch.cat(out, dim=1)
    dt = time.time() - t0
    print(f"decoded {G} tokens/seq in {dt:.2f}s ({B * G / dt:.1f} tok/s "
          f"greedy); sample row: {gen[0, :16].tolist()}")
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="zamba2-1.2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=48)
    ap.add_argument("--engine", action="store_true",
                    help="continuous-batching ServingEngine path")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--telemetry-jsonl", default=None,
                    help="(--engine only) enable serving telemetry and "
                         "write events to this JSONL file")
    args = ap.parse_args(argv)
    if args.telemetry_jsonl and not args.engine:
        ap.error("--telemetry-jsonl needs the --engine path (the batch-"
                 "synchronous demo has no serving telemetry)")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch).reduced()
    if args.engine:
        return run_engine(cfg, args, device)
    return run_batch(cfg, args, device)


if __name__ == "__main__":
    main()
