"""Continuous-batching serving engine (counterpart of the JAX package's
``serving/engine.py``).

Drives the steps of ``repro_torch.launch.serve`` over a fixed-slot batch:
admitted requests prefill in chunks (one slot at a time, a batch-1 cache
slice) interleaved with one batched single-token decode of every
in-flight request (per-slot positions and an active mask).  The cache is
an opaque tree to the engine; only ``CacheManager``'s accounting looks at
the block kinds.

Greedy decode of a request gives the same tokens whether it runs alone or
batched (per-row cache isolation and masked writes); sampling is
batch-independent as well, because a row's Gumbel draws depend only on
(request seed, output position).  The engine runs on the card unless
given ``device="cpu"``.

    engine = ServingEngine(cfg, params, sched=SchedulerConfig(n_slots=8))
    engine.add_request(prompt_tokens, max_new_tokens=32)
    outputs = engine.run()
"""
from __future__ import annotations

import time
from typing import List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.launch.serve import make_prefill_chunk_step, make_serve_step
from repro_torch.models.registry import get_model
from repro_torch.serving.cache import CacheManager
from repro_torch.serving.request import (DECODE, FINISHED, Request,
                                         RequestOutput, SamplingParams)
from repro_torch.serving.sampling import gumbel_noise, sample_tokens
from repro_torch.serving.scheduler import Scheduler, SchedulerConfig
from repro_torch.telemetry import Telemetry


class ServingEngine:
    """``gumbel_fn(seeds, counters, vocab, device)`` -> (B, vocab) fp32
    gives the sampling draws of B rows (default: ``gumbel_noise``); the
    parity tests pass the reference's own draws through it."""

    def __init__(self, mcfg: ModelConfig, params=None,
                 sched: SchedulerConfig = None, dtype=torch.float32,
                 init_seed: int = 0, telemetry: Telemetry = None,
                 device=None, gumbel_fn=gumbel_noise):
        if mcfg.is_encoder_decoder:
            raise ValueError(
                "ServingEngine serves decoder-only archs; enc-dec (whisper) "
                "uses the batch-synchronous path (serve_demo.py)")
        self.mcfg = mcfg
        self.device = resolve_device(device)
        self.sched_cfg = sched or SchedulerConfig()
        model = get_model(mcfg)
        if params is None:
            params = model.init(init_seed, mcfg, device=self.device)
        self.params = params
        self.cachemgr = CacheManager(
            mcfg, self.sched_cfg.n_slots, self.sched_cfg.max_len,
            page_size=self.sched_cfg.page_size, dtype=dtype,
            device=self.device)
        self.scheduler = Scheduler(self.sched_cfg, self.cachemgr)
        self._decode_step = make_serve_step(mcfg)
        self._chunk_step = make_prefill_chunk_step(
            mcfg, self.sched_cfg.prefill_chunk)
        self._gumbel_fn = gumbel_fn
        self._next_rid = 0
        self.n_steps = 0
        self.telemetry = telemetry if telemetry is not None \
            else Telemetry.disabled("serving")
        if not self.telemetry.engine:
            self.telemetry.engine = "serving"

    # ------------------------------------------------------------------
    def add_request(self, prompt: Sequence[int], max_new_tokens: int = 16,
                    sampling: SamplingParams = None) -> int:
        if len(prompt) < 1 or max_new_tokens < 1:
            raise ValueError("need a non-empty prompt and max_new_tokens>=1")
        total = len(prompt) + max_new_tokens
        if self.cachemgr.has_kv and total > self.sched_cfg.max_len:
            raise ValueError(
                f"request needs {total} cache positions > max_len="
                f"{self.sched_cfg.max_len} (KV cache would wrap)")
        rid = self._next_rid
        self._next_rid += 1
        req = Request(rid, [int(t) for t in prompt], max_new_tokens,
                      sampling or SamplingParams(),
                      arrival_t=time.perf_counter())
        self.scheduler.submit(req)
        return rid

    def has_work(self) -> bool:
        return self.scheduler.has_work()

    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One scheduler step: admit, one prefill chunk, one batched decode
        step.  Returns the requests that finished during this step."""
        tel = self.telemetry
        finished: List[Request] = []
        self.scheduler.admit_ready()
        req = self.scheduler.next_prefill()
        if req is not None:
            with tel.tracer.span("prefill_chunk"):
                self._prefill_one_chunk(req, finished)
        dec = self.scheduler.decode_requests()
        if dec:
            with tel.tracer.span("decode_step"):
                self._decode_all(dec, finished)
        self.n_steps += 1
        if tel.enabled:
            # the scheduler's gauges and the step counter: host ints
            tel.counters.set("serving.queue_depth", len(self.scheduler.queue))
            tel.counters.set("serving.slots_occupied",
                             sum(r is not None for r in self.scheduler.slots))
            tel.counters.inc("serving.steps")
        outs = [self._output(r) for r in finished]
        for o in outs:
            tel.record_request(o)
        return outs

    def run(self, max_steps: int = 100_000) -> List[RequestOutput]:
        """Drive steps until queue and slots drain; outputs by rid."""
        outputs: List[RequestOutput] = []
        steps = 0
        while self.has_work():
            outputs.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(f"engine did not drain in {max_steps} steps")
        outputs = sorted(outputs, key=lambda o: o.rid)
        if self.telemetry.enabled and outputs:
            self.telemetry.emit_summary(outputs)
        return outputs

    # ------------------------------------------------------------------
    def _prefill_one_chunk(self, req: Request, finished: List[Request]):
        C = self.sched_cfg.prefill_chunk
        P = len(req.prompt)
        n = min(C, P - req.prefilled)
        buf = np.zeros((1, C), np.int64)
        buf[0, :n] = req.prompt[req.prefilled:req.prefilled + n]
        last_logits, part = self._chunk_step(
            self.params, self.cachemgr.slot_view(req.slot),
            torch.from_numpy(buf).to(self.device), req.prefilled, n)
        self.cachemgr.write_slot(req.slot, part)
        req.prefilled += n
        if req.prefilled == P:
            tok = int(self._sample(last_logits, [req])[0])
            req.out_tokens.append(tok)
            req.first_token_t = time.perf_counter()
            req.state = DECODE
            if len(req.out_tokens) >= req.max_new_tokens:
                self._finish(req, finished)

    def _decode_all(self, dec, finished: List[Request]):
        # full-width (n_slots) batches, as the reference decodes; the
        # inactive rows sample tokens that are never read
        B = self.sched_cfg.n_slots
        tokens = np.zeros((B, 1), np.int64)
        pos = np.zeros((B,), np.int64)
        active = np.zeros((B,), bool)
        rows: List[Request] = [None] * B
        for slot, r in dec:
            tokens[slot, 0] = r.out_tokens[-1]
            pos[slot] = len(r.prompt) + len(r.out_tokens) - 1
            active[slot] = True
            rows[slot] = r
        logits, self.cachemgr.cache = self._decode_step(
            self.params, self.cachemgr.cache,
            torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(pos).to(self.device),
            torch.from_numpy(active).to(self.device))
        toks = self._sample(logits, rows)
        for slot, r in dec:
            r.out_tokens.append(int(toks[slot]))
            if len(r.out_tokens) >= r.max_new_tokens:
                self._finish(r, finished)

    def _sample(self, logits, reqs: List[Request]):
        """One token per row of ``logits`` from its request's sampling
        parameters (greedy for a row without a request) -> numpy int32."""
        sp = [r.sampling if r is not None else SamplingParams() for r in reqs]
        seeds = [s.seed for s in sp]
        counters = [len(r.out_tokens) if r is not None else 0 for r in reqs]
        temps = [s.temperature for s in sp]
        gumbel = None
        if any(t > 0 for t in temps):
            gumbel = self._gumbel_fn(seeds, counters, logits.shape[-1],
                                     logits.device)
        return sample_tokens(logits, temps, [s.top_k for s in sp], seeds,
                             counters, gumbel=gumbel).cpu().numpy()

    def _finish(self, req: Request, finished: List[Request]):
        req.state = FINISHED
        req.finish_t = time.perf_counter()
        self.scheduler.release(req)
        finished.append(req)

    @staticmethod
    def _output(req: Request) -> RequestOutput:
        return RequestOutput(req.rid, req.prompt, list(req.out_tokens),
                             req.arrival_t, req.first_token_t, req.finish_t)
