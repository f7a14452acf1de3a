"""GQA attention (counterpart of the JAX package's ``models/attention.py:27-141``):
optional qk-norm (Qwen3), qkv bias (Qwen1.5), sliding window (Llama-4
chunked and the long-context variants), full causal (Mistral, Zamba2's
shared block).  MLA and cross-attention come with the rest of the LM
stack.

``use_pallas=True`` is the kernel route: causal attention without a window
goes to ``ops.flash_attention`` (the CUDA kernel on a CUDA tensor, its
plain version on a CPU tensor); windowed layers take the masked route even
then, as ``sdpa_auto`` sends them in the reference.  ``use_pallas=False``
is the reference's own masked softmax, with its q-block chunking for long
sequences.  The single-token decode against a cache lives in
``transformer._block_decode``.
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
