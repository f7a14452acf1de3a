"""Serving steps (counterpart of the JAX package's ``launch/serve.py``).

The inner steps the continuous-batching engine (``repro_torch.serving``)
drives:

* ``prefill_step``       — full-sequence forward, argmax of the last
  logits: each prompt's first token (the ``prefill_32k`` shape).  With
  ``use_pallas=True`` its Mamba2 blocks run the SSD kernel and its causal
  attention the flash kernel.
* ``serve_step``         — ONE new token per slot against a KV/state cache,
  with per-slot positions (B,) and an ``active`` mask, so slots at
  different depths (or empty ones) batch into one call.  Returns raw
  logits; sampling is the engine's job.
* ``prefill_chunk_step`` — ingest a chunk of one slot's prompt tokens
  (a batch-1 cache slice) as a loop of decode steps, which the engine
  interleaves with batched decode.

The steps run where the parameters are; nothing here picks a device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import get_model


def make_prefill_step(mcfg: ModelConfig, use_pallas: bool = False):
    """-> prefill_step(params, {"tokens": (B, L)}) -> first tokens (B,)
    int32."""
    model = get_model(mcfg)

    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch, mcfg, use_pallas,
                                  logits_slice="last")
        return logits[:, -1].argmax(-1).to(torch.int32)
    return prefill_step


def make_serve_step(mcfg: ModelConfig):
    """-> serve_step(params, cache, tokens (B, 1), cur_pos (B,) | int,
    active (B,) bool | None) -> (logits (B, V), new cache)."""
    model = get_model(mcfg)

    def serve_step(params, cache, tokens, cur_pos, active=None):
        return model.decode_step(params, cache, tokens, cur_pos, mcfg,
                                 active=active)
    return serve_step


def make_prefill_chunk_step(mcfg: ModelConfig, chunk: int):
    """-> chunk_step(params, slot_cache (batch 1), tokens (1, chunk), pos0,
    n_valid) -> (last_logits (1, V) fp32, slot_cache).

    Decode steps at positions pos0, pos0 + 1, ... over one slot's cache.
    Tokens at and after ``n_valid`` are padding.  The reference scans all
    ``chunk`` steps and masks the padding steps' cache writes and logits
    out; here they are not run, which leaves the same cache and the same
    last logits (those of the final valid token)."""
    model = get_model(mcfg)

    def chunk_step(params, slot_cache, tokens, pos0, n_valid):
        last = torch.zeros((1, mcfg.vocab_size), dtype=torch.float32,
                           device=tokens.device)
        for i in range(min(int(n_valid), chunk)):
            logits, slot_cache = model.decode_step(
                params, slot_cache, tokens[:, i:i + 1], int(pos0) + i, mcfg)
            last = logits.float()
        return last, slot_cache
    return chunk_step


def cache_shapes(mcfg: ModelConfig, batch: int, max_len: int,
                 dtype=torch.bfloat16):
    """The cache tree on the ``meta`` device: shapes and dtypes, no memory."""
    return get_model(mcfg).init_cache(mcfg, batch, max_len, dtype,
                                      device="meta")
