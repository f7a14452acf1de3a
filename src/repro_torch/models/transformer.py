"""Decoder-only stack assembler (counterpart of the JAX package's
``models/transformer.py``) for every block kind: dense attention (GQA or
MLA), MoE (attention and a routed FFN), Mamba2, the xLSTM's mLSTM and
sLSTM, and Zamba2-style shared attention; with the VLM's patch prefix
(precomputed patch embeddings through ``vis_proj`` ahead of the tokens).

Consecutive blocks of one kind and window form a run whose parameters are
stacked along a leading layer axis, as the reference stacks them for its
``lax.scan``; here the scan is a Python loop over that axis, and each
layer's parameters are views into the stacked tensors, not copies.  A
``SHARED_ATTN`` block has one set of parameters (``params["shared_attn"]``)
applied at every place the pattern names it, each with a cache of its own.

The forward, ``decode_step`` and caches are functional like the
reference's: ``decode_step`` returns a new cache and leaves the one it was
given as it was.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import (ATTN, MAMBA2, MLSTM, MOE, SHARED_ATTN,
                                      SLSTM, ModelConfig)
from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as M2
from repro_torch.models import moe as MOE_MOD
from repro_torch.models import xlstm as XL

VIS_EMBED_DIM = 1024   # the stub vision tower's output width (InternViT)


# ---------------------------------------------------------------------------
# Run partitioning
# ---------------------------------------------------------------------------
def layer_window(cfg: ModelConfig, block_idx: int) -> int:
    return cfg.sliding_window if cfg.layer_uses_window(block_idx) else 0


def partition_runs(cfg: ModelConfig) -> List[Tuple[str, int, List[int]]]:
    """-> [(kind, window, [block indices])] preserving order."""
    runs: List[Tuple[str, int, List[int]]] = []
    for i, kind in enumerate(cfg.blocks()):
        win = layer_window(cfg, i) if kind in (ATTN, MOE, SHARED_ATTN) else 0
        if runs and runs[-1][0] == kind and runs[-1][1] == win \
                and kind != SHARED_ATTN:
            runs[-1][2].append(i)
        else:
            runs.append((kind, win, [i]))
    return runs


def layer(stacked, i: int):
    """Layer ``i`` of a stacked run: views into the stacked tensors."""
    return tree_map(lambda t: t[i], stacked)


# ---------------------------------------------------------------------------
# Per-block init / apply
# ---------------------------------------------------------------------------
def _block_init(kind: str, gen, cfg: ModelConfig, dtype, device, lead=()):
    if kind in (ATTN, SHARED_ATTN, MOE):
        p = {"ln1": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
             "ln2": L.rmsnorm_init(cfg.d_model, dtype, device, lead)}
        p["attn"] = (A.mla_init if cfg.mla is not None else A.gqa_init)(
            gen, cfg, dtype, device, lead)
        if kind == MOE:
            p["moe"] = MOE_MOD.moe_init(gen, cfg, dtype, device, lead)
        else:
            d_ff = cfg.d_ff if cfg.d_ff > 0 else 4 * cfg.d_model
            p["mlp"] = L.mlp_init(gen, cfg.d_model, d_ff, dtype, device,
                                  lead)
        return p
    mix = {MAMBA2: M2.mamba2_init, MLSTM: XL.mlstm_init,
           SLSTM: XL.slstm_init}[kind]
    return {"ln": L.rmsnorm_init(cfg.d_model, dtype, device, lead),
            "mix": mix(gen, cfg, dtype, device, lead)}


def _attn_fwd(p, x, cfg, window, use_pallas):
    if cfg.mla is not None:
        return A.mla_forward(p, x, cfg, use_pallas=use_pallas)
    B, Lq, _ = x.shape
    positions = torch.arange(Lq, device=x.device)[None, :]
    q, k, v = A._gqa_qkv(p, x, cfg, positions)
    out = A.sdpa_auto(q, k, v, causal=True, window=window,
                      use_pallas=use_pallas)
    return L.linear(p["wo"], out.reshape(B, Lq, -1))


def _block_fwd(kind: str, p, x, cfg: ModelConfig, window: int,
               use_pallas: bool):
    """-> (x, aux loss or None)."""
    if kind in (ATTN, SHARED_ATTN, MOE):
        x = x + _attn_fwd(p["attn"], L.rmsnorm(p["ln1"], x, cfg.norm_eps),
                          cfg, window, use_pallas)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        if kind == MOE:
            y, aux = MOE_MOD.moe_apply(p["moe"], h, cfg)
            return x + y, aux
        return x + L.mlp(p["mlp"], h), None
    h = L.rmsnorm(p["ln"], x, cfg.norm_eps)
    if kind == MAMBA2:
        return x + M2.mamba2_forward(p["mix"], h, cfg, use_pallas), None
    mix = XL.mlstm_forward if kind == MLSTM else XL.slstm_forward
    return x + mix(p["mix"], h, cfg), None


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------
def init(seed: int, cfg: ModelConfig, dtype=torch.float32, device=None
         ) -> Dict:
    """Parameters from a ``torch.Generator`` seeded with ``seed`` on
    ``device`` (the card unless given; ``"meta"`` gives shapes only), with
    the reference's key paths and stacking."""
    device = resolve_device(device)
    gen = None if device.type == "meta" \
        else torch.Generator(device=device).manual_seed(seed)
    params: Dict = {"embed": L.embedding_init(gen, cfg.vocab_size,
                                              cfg.d_model, dtype, device)}
    run_params = {}
    for ri, (kind, win, idxs) in enumerate(partition_runs(cfg)):
        if kind == SHARED_ATTN:
            if "shared_attn" not in params:
                params["shared_attn"] = _block_init(SHARED_ATTN, gen, cfg,
                                                    dtype, device)
            continue
        run_params[str(ri)] = _block_init(kind, gen, cfg, dtype, device,
                                          lead=(len(idxs),))
    params["runs"] = run_params
    params["final_norm"] = L.rmsnorm_init(cfg.d_model, dtype, device)
    if not cfg.tie_embeddings:
        params["lm_head"] = L.linear_init(gen, cfg.d_model, cfg.vocab_size,
                                          dtype=dtype, device=device)
    if cfg.n_patch_tokens > 0:
        params["vis_proj"] = L.linear_init(gen, VIS_EMBED_DIM, cfg.d_model,
                                           bias=True, dtype=dtype,
                                           device=device)
    return params


def _embed_inputs(params, batch, cfg):
    """Token embeddings, behind the projected patch embeddings where the
    config has a patch prefix and the batch carries them."""
    x = L.embed(params["embed"], batch["tokens"])
    if cfg.n_patch_tokens > 0 and "patch_embeds" in batch:
        vis = L.linear(params["vis_proj"], batch["patch_embeds"].to(x.dtype))
        x = torch.cat([vis, x], dim=1)
    return x


def _unembed(params, x, cfg):
    if cfg.tie_embeddings:
        return x @ params["embed"]["emb"].T.to(x.dtype)
    return L.linear(params["lm_head"], x)


def checkpointed(fn, remat: str):
    """``fn`` as a block of a run: recomputed in the backward pass unless
    ``remat == "none"`` (the counterpart of the reference's
    ``jax.checkpoint`` around its scan body).  The blocks draw no random
    numbers, so the RNG state is not saved."""
    if remat == "none":
        return fn

    def block(*args):
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return block


def forward(params, batch, cfg: ModelConfig, use_pallas: bool = False,
            remat: str = "none", logits_slice: str = "all"):
    """-> (logits (B, L [+ patches], V), aux loss: the MoE blocks' load
    balance, summed, fp32).  ``remat`` other than ``"none"`` recomputes
    each block of a run in the backward pass instead of keeping its
    activations (a shared attention block is kept, as the reference keeps
    it outside its scan).  ``logits_slice="last"`` unembeds only the final
    position (the serving prefill)."""
    x = _embed_inputs(params, batch, cfg)
    aux = torch.zeros((), device=x.device)
    run_block = checkpointed(_block_fwd, remat)
    for ri, (kind, win, idxs) in enumerate(partition_runs(cfg)):
        if kind == SHARED_ATTN:
            x, a = _block_fwd(kind, params["shared_attn"], x, cfg, win,
                              use_pallas)
            if a is not None:
                aux = aux + a
            continue
        stacked = params["runs"][str(ri)]
        for i in range(len(idxs)):
            x, a = run_block(kind, layer(stacked, i), x, cfg, win,
                             use_pallas)
            if a is not None:
                aux = aux + a
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if logits_slice == "last":
        x = x[:, -1:]
    return _unembed(params, x, cfg), aux


def loss_fn(params, batch, cfg: ModelConfig, use_pallas: bool = False,
            remat: str = "none"):
    """Next-token cross-entropy over the text positions (the patch prefix's
    logits are cut off); positions with label < 0 are masked.  -> (ce +
    aux, {"ce", "aux"})."""
    logits, aux = forward(params, batch, cfg, use_pallas, remat)
    if cfg.n_patch_tokens > 0 and "patch_embeds" in batch:
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    return _next_token_ce(logits, batch["labels"], aux)


def _next_token_ce(logits, labels, aux):
    logits = logits[:, :-1].float()
    targets = labels[:, 1:]
    mask = (targets >= 0).float()
    tgt = targets.clamp_min(0).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tgt[..., None])[..., 0]
    ce = torch.sum((lse - gold) * mask) / torch.clamp_min(mask.sum(), 1.0)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode (serve_step): one token against a cache.
# ---------------------------------------------------------------------------
def _layer_cache(kind, win, cfg, batch, max_len, dtype, device):
    """One layer's cache, batch rows first."""
    if kind in (ATTN, MOE, SHARED_ATTN):
        if cfg.mla is not None:
            return A.mla_init_cache(cfg, batch, max_len, dtype, device)
        S = min(max_len, win) if win > 0 else max_len
        kv = (batch, S, cfg.n_kv_heads, cfg.resolved_head_dim)
        return {"k": torch.zeros(kv, dtype=dtype, device=device),
                "v": torch.zeros(kv, dtype=dtype, device=device),
                "kpos": torch.full((batch, S), -1, dtype=torch.int32,
                                   device=device)}
    init_cache = {MAMBA2: M2.mamba2_init_cache, MLSTM: XL.mlstm_init_cache,
                  SLSTM: XL.slstm_init_cache}[kind]
    return init_cache(cfg, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None):
    """Per-slot caches, every leaf (n_layers of the run, batch, ...): each
    sequence carries its own write position (``kpos`` (batch, S)), so the
    serving engine decodes requests at different depths in one step.
    Recurrent states (Mamba2, xLSTM) are fp32 whatever ``dtype``."""
    device = resolve_device(device)
    cache: Dict = {}
    for ri, (kind, win, idxs) in enumerate(partition_runs(cfg)):
        one = _layer_cache(kind, win, cfg, batch, max_len, dtype, device)
        cache[str(ri)] = {k: v.expand((len(idxs),) + v.shape).clone()
                          for k, v in one.items()}
    return cache


def _block_decode(kind, p, x, c, cfg, cur_pos):
    if kind in (MAMBA2, MLSTM, SLSTM):
        decode = {MAMBA2: M2.mamba2_decode, MLSTM: XL.mlstm_decode,
                  SLSTM: XL.slstm_decode}[kind]
        y, c = decode(p["mix"], L.rmsnorm(p["ln"], x, cfg.norm_eps), c, cfg)
        return x + y, c
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if cfg.mla is not None:
        y, c = A.mla_decode(p["attn"], h, c, cfg, cur_pos)
    else:
        # the window lives in the cache size (a ring buffer) and the kpos
        # mask; each slot writes its own ring position
        B = x.shape[0]
        q, k, v = A._gqa_qkv(p["attn"], h, cfg, cur_pos[:, None])
        S = c["k"].shape[1]
        at = (torch.arange(B, device=x.device), torch.remainder(cur_pos, S))
        ck = c["k"].index_put(at, k[:, 0].to(c["k"].dtype))
        cv = c["v"].index_put(at, v[:, 0].to(c["v"].dtype))
        kpos = c["kpos"].index_put(at, cur_pos.to(c["kpos"].dtype))
        valid = (kpos >= 0) & (kpos <= cur_pos[:, None])
        out = A._sdpa(q, ck, cv, valid[:, None, None, :])
        y = L.linear(p["attn"]["wo"], out.reshape(B, 1, -1))
        c = {"k": ck, "v": cv, "kpos": kpos}
    x = x + y
    h2 = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
    if kind == MOE:
        return x + MOE_MOD.moe_apply(p["moe"], h2, cfg)[0], c
    return x + L.mlp(p["mlp"], h2), c


def decode_step(params, cache, tokens, cur_pos, cfg: ModelConfig,
                active=None):
    """tokens (B, 1) int; cur_pos an int or (B,) ints -> (logits (B, V),
    new cache).  A scalar cur_pos broadcasts (all sequences at one depth);
    a (B,) vector decodes per-slot positions, the continuous-batching path.
    ``active`` (B,) bool, when given, masks the cache update per slot:
    inactive slots keep their prior cache bit for bit."""
    B = tokens.shape[0]
    cur_pos = torch.as_tensor(cur_pos, device=tokens.device).long()
    cur_pos = cur_pos.reshape(-1).expand(B)
    x = L.embed(params["embed"], tokens)
    new_cache: Dict = {}
    for ri, (kind, win, idxs) in enumerate(partition_runs(cfg)):
        c = cache[str(ri)]
        shared = kind == SHARED_ATTN
        p = params["shared_attn"] if shared else params["runs"][str(ri)]
        layers = []
        for i in range(len(idxs)):
            x, lc = _block_decode(kind, p if shared else layer(p, i), x,
                                  layer(c, i), cfg, cur_pos)
            layers.append(lc)
        new_cache[str(ri)] = {k: torch.stack([lc[k] for lc in layers])
                              for k in layers[0]}
    if active is not None:
        active = torch.as_tensor(active, device=tokens.device)
        # every cache leaf is (n_layers, B, ...): mask axis 1
        new_cache = tree_map(lambda new, old: torch.where(
            active.reshape((1, B) + (1,) * (new.dim() - 2)), new, old),
            new_cache, cache)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _unembed(params, x, cfg)[:, 0], new_cache
