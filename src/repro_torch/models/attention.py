"""Attention variants (counterpart of the JAX package's
``models/attention.py``):

* GQA with optional qk-norm (Qwen3), qkv bias (Qwen1.5, InternLM2), sliding
  window (Llama-4 chunked and the long-context variants), full causal
  (Mistral, Zamba2's shared block);
* MLA (DeepSeek-V3 multi-head latent attention): the expanded form for the
  full sequence, and a weight-absorbed decode whose scores and values are
  products against the compressed latent cache, all in fp32;
* cross-attention (the Whisper decoder): unmasked, biases on q, v and o.

``use_pallas=True`` is the kernel route: causal attention without a window
goes to ``ops.flash_attention`` (the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor); windowed layers take the masked route even
then, as ``sdpa_auto`` sends them in the reference.  ``use_pallas=False``
is the reference's own masked softmax, with its q-block chunking for long
sequences.  MLA and cross-attention never take the kernel: the reference
calls ``sdpa_auto`` for MLA without ``use_pallas`` (its qk head dim, 192,
is one the flash kernel does not take either).  The GQA single-token
decode against a cache lives in ``transformer._block_decode``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.models import layers as L

NEG_INF = -1e30


def _sdpa(q, k, v, mask, use_pallas: bool = False):
    """q (B, Lq, H, D), k/v (B, Lk, Hk, D[v]), mask (B|1, 1, Lq, Lk) bool
    or None -> (B, Lq, H, Dv) in q's dtype."""
    if use_pallas and mask is None:
        return ops.flash_attention(q, k, v, causal=True)
    B, Lq, H, D = q.shape
    Hk = k.shape[2]
    g = H // Hk
    qf = (q.float() * (D ** -0.5)).reshape(B, Lq, Hk, g, D)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, k.float())
    if mask is not None:
        m = mask[:, :, None] if mask.dim() == 4 else mask
        scores = torch.where(m, scores, torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", w, v.float())
    return out.reshape(B, Lq, H, v.shape[-1]).to(q.dtype)


CHUNK_THRESHOLD = 8192     # sequences at/above this use q-block chunking
CHUNK_BLOCK_Q = 1024


def sdpa_auto(q, k, v, causal=True, window=0, use_pallas=False):
    """Full-sequence attention.  Long sequences (Lq ≥ 8192, a multiple of
    1024) are cut into q blocks of 1024, so the live score tensor is (H,
    1024, Lk) instead of (H, Lq, Lk); under a window each block reads only
    its (window + 1024)-key band."""
    B, Lq, H, D = q.shape
    if use_pallas and window == 0 and causal:
        return _sdpa(q, k, v, None, use_pallas=True)
    if Lq < CHUNK_THRESHOLD or Lq % CHUNK_BLOCK_Q != 0:
        mask = causal_window_mask(Lq, Lq, window, device=q.device) \
            if (causal or window) else None
        return _sdpa(q, k, v, mask)
    bq = CHUNK_BLOCK_Q
    band = min(window + bq, Lq) if window > 0 else Lq
    outs = []
    for i in range(Lq // bq):
        off = i * bq
        qblk = q[:, off:off + bq]
        if window > 0 and band < Lq:
            start = min(max(off + bq - band, 0), Lq - band)
            kb, vb = k[:, start:start + band], v[:, start:start + band]
            qpos = off + torch.arange(bq, device=q.device)[:, None]
            kpos = start + torch.arange(band, device=q.device)[None, :]
            mask = ((kpos <= qpos) & (kpos > qpos - window))[None, None]
            outs.append(_sdpa(qblk, kb, vb, mask))
        else:
            mask = causal_window_mask(bq, Lq, window, q_offset=off,
                                      device=q.device) \
                if (causal or window) else None
            outs.append(_sdpa(qblk, k, v, mask))
    return torch.cat(outs, dim=1)


def causal_window_mask(lq: int, lk: int, window: int, q_offset: int = 0,
                       device=None):
    """(1, 1, lq, lk) bool mask; window <= 0 means full causal."""
    qpos = torch.arange(lq, device=device)[:, None] + q_offset
    kpos = torch.arange(lk, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
def gqa_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(bias=cfg.qkv_bias, dtype=dtype, device=device, lead=lead)
    p = {"wq": L.linear_init(gen, d, cfg.n_heads * hd, **kw),
         "wk": L.linear_init(gen, d, cfg.n_kv_heads * hd, **kw),
         "wv": L.linear_init(gen, d, cfg.n_kv_heads * hd, **kw),
         "wo": L.linear_init(gen, cfg.n_heads * hd, d, dtype=dtype,
                             device=device, lead=lead)}
    if cfg.qk_norm:
        p["q_norm"] = L.rmsnorm_init(hd, dtype, device, lead)
        p["k_norm"] = L.rmsnorm_init(hd, dtype, device, lead)
    return p


def _gqa_qkv(p, x, cfg, positions):
    B, Lq, _ = x.shape
    hd = cfg.resolved_head_dim
    q = L.linear(p["wq"], x).reshape(B, Lq, cfg.n_heads, hd)
    k = L.linear(p["wk"], x).reshape(B, Lq, cfg.n_kv_heads, hd)
    v = L.linear(p["wv"], x).reshape(B, Lq, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm(p["k_norm"], k, cfg.norm_eps)
    cos, sin = L.rope_freqs(hd, cfg.rope_theta, positions)
    return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v


def gqa_forward(p, x, cfg, layer_idx: int, use_pallas: bool = False):
    B, Lq, _ = x.shape
    positions = torch.arange(Lq, device=x.device)[None, :]
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    window = cfg.sliding_window if cfg.layer_uses_window(layer_idx) else 0
    out = sdpa_auto(q, k, v, causal=True, window=window,
                    use_pallas=use_pallas)
    return L.linear(p["wo"], out.reshape(B, Lq, -1))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3)
# ---------------------------------------------------------------------------
def mla_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    m = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk_dim = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wdq": L.linear_init(gen, d, m.q_lora_rank, **kw),
        "q_norm": L.rmsnorm_init(m.q_lora_rank, dtype, device, lead),
        "wuq": L.linear_init(gen, m.q_lora_rank, H * qk_dim, **kw),
        "wdkv": L.linear_init(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                              **kw),
        "kv_norm": L.rmsnorm_init(m.kv_lora_rank, dtype, device, lead),
        "wuk": L.linear_init(gen, m.kv_lora_rank, H * m.qk_nope_head_dim,
                             **kw),
        "wuv": L.linear_init(gen, m.kv_lora_rank, H * m.v_head_dim, **kw),
        "wo": L.linear_init(gen, H * m.v_head_dim, d, **kw),
    }


def _mla_q(p, x, cfg, positions):
    m = cfg.mla
    B, Lq, _ = x.shape
    q = L.linear(p["wuq"], L.rmsnorm(p["q_norm"], L.linear(p["wdq"], x),
                                     cfg.norm_eps))
    q = q.reshape(B, Lq, cfg.n_heads, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_rope = q.split([m.qk_nope_head_dim, m.qk_rope_head_dim], -1)
    cos, sin = L.rope_freqs(m.qk_rope_head_dim, cfg.rope_theta, positions)
    return q_nope, L.apply_rope(q_rope, cos, sin)


def _mla_latent(p, x, cfg, positions):
    m = cfg.mla
    c_kv, k_rope = L.linear(p["wdkv"], x).split(
        [m.kv_lora_rank, m.qk_rope_head_dim], -1)
    c_kv = L.rmsnorm(p["kv_norm"], c_kv, cfg.norm_eps)
    cos, sin = L.rope_freqs(m.qk_rope_head_dim, cfg.rope_theta, positions)
    return c_kv, L.apply_rope(k_rope[:, :, None, :], cos, sin)[:, :, 0, :]


def mla_forward(p, x, cfg, layer_idx: int = 0, use_pallas: bool = False):
    """The expanded form (train, prefill).  ``use_pallas`` is taken and
    ignored, as in the reference: MLA's attention is the masked route."""
    m = cfg.mla
    B, Lq, _ = x.shape
    H = cfg.n_heads
    positions = torch.arange(Lq, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)
    k_nope = L.linear(p["wuk"], c_kv).reshape(B, Lq, H, m.qk_nope_head_dim)
    v = L.linear(p["wuv"], c_kv).reshape(B, Lq, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], -1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, Lq, H, m.qk_rope_head_dim)], -1)
    out = sdpa_auto(q, k, v, causal=True)
    return L.linear(p["wo"], out.reshape(B, Lq, -1))


def mla_init_cache(cfg, batch: int, max_len: int, dtype, device=None):
    m = cfg.mla
    return {"c_kv": torch.zeros((batch, max_len, m.kv_lora_rank),
                                dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, m.qk_rope_head_dim),
                                  dtype=dtype, device=device),
            "kpos": torch.full((batch, max_len), -1, dtype=torch.int32,
                               device=device)}


def mla_decode(p, x, cache, cfg, cur_pos):
    """Weight-absorbed decode: W_uk folds into q and W_uv into the output,
    so scores and values are products against the latent cache and the
    per-head K/V never form.  cur_pos (B,): each slot writes and masks its
    own position.  -> (y (B, 1, d), new cache)."""
    m = cfg.mla
    B, H = x.shape[0], cfg.n_heads
    f32 = torch.float32
    positions = cur_pos[:, None]
    q_nope, q_rope = _mla_q(p, x, cfg, positions)          # (B, 1, H, *)
    c_kv, k_rope = _mla_latent(p, x, cfg, positions)       # (B, 1, r|dr)
    at = (torch.arange(B, device=x.device),
          torch.remainder(cur_pos, cache["c_kv"].shape[1]))
    cc = cache["c_kv"].index_put(at, c_kv[:, 0].to(cache["c_kv"].dtype))
    cr = cache["k_rope"].index_put(at, k_rope[:, 0].to(cache["k_rope"].dtype))
    kpos = cache["kpos"].index_put(at, cur_pos.to(cache["kpos"].dtype))
    wuk = p["wuk"]["w"].reshape(m.kv_lora_rank, H, m.qk_nope_head_dim)
    q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope.to(f32), wuk.to(f32))
    scale = (m.qk_nope_head_dim + m.qk_rope_head_dim) ** -0.5
    s1 = torch.einsum("bqhr,bkr->bhqk", q_abs, cc.to(f32))
    s2 = torch.einsum("bqhd,bkd->bhqk", q_rope.to(f32), cr.to(f32))
    scores = (s1 + s2) * scale
    valid = (kpos >= 0) & (kpos <= cur_pos[:, None])
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    w = torch.softmax(scores, dim=-1)
    out_lat = torch.einsum("bhqk,bkr->bqhr", w, cc.to(f32))
    wuv = p["wuv"]["w"].reshape(m.kv_lora_rank, H, m.v_head_dim)
    out = torch.einsum("bqhr,rhd->bqhd", out_lat, wuv.to(f32))
    y = L.linear(p["wo"], out.reshape(B, 1, -1).to(x.dtype))
    return y, {"c_kv": cc, "k_rope": cr, "kpos": kpos}


# ---------------------------------------------------------------------------
# Cross-attention (the Whisper decoder)
# ---------------------------------------------------------------------------
def cross_attn_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {"wq": L.linear_init(gen, d, cfg.n_heads * hd, bias=True, **kw),
            "wk": L.linear_init(gen, d, cfg.n_kv_heads * hd, **kw),
            "wv": L.linear_init(gen, d, cfg.n_kv_heads * hd, bias=True, **kw),
            "wo": L.linear_init(gen, cfg.n_heads * hd, d, bias=True, **kw)}


def cross_attn(p, x, enc_out, cfg):
    B, Lq, _ = x.shape
    Lk = enc_out.shape[1]
    hd = cfg.resolved_head_dim
    q = L.linear(p["wq"], x).reshape(B, Lq, cfg.n_heads, hd)
    k = L.linear(p["wk"], enc_out).reshape(B, Lk, cfg.n_kv_heads, hd)
    v = L.linear(p["wv"], enc_out).reshape(B, Lk, cfg.n_kv_heads, hd)
    return L.linear(p["wo"], _sdpa(q, k, v, None).reshape(B, Lq, -1))
