"""Mamba2 (SSD) block, Zamba2's backbone (counterpart of the JAX package's
``models/mamba2.py``).

Prefill runs the chunked SSD: ``use_pallas=True`` goes to
``ops.ssd_scan`` (the CUDA kernel on a CUDA tensor, its plain sequential
version on a CPU tensor), ``use_pallas=False`` to ``ssd_chunked``, the
reference's own einsum formulation with its inter-chunk scan as a loop.
Decode is the O(1) state recurrence.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import layers as L


def mamba2_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    """The reference's distributions (``mamba2.py:18-35``): linears uniform
    ±1/√fan_in, ``conv_w`` normal·0.02, ``A_log = log(1..H)``, ``D = 1``,
    ``dt_bias = 0``; the last three fp32 whatever ``dtype``."""
    s = cfg.ssm
    d = cfg.d_model
    d_inner = s.expand * d
    H = d_inner // s.head_dim
    G, N = s.n_groups, s.d_state
    conv_ch = d_inner + 2 * G * N
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.linear_init(gen, d, 2 * d_inner + 2 * G * N + H,
                                 dtype=dtype, device=device, lead=lead),
        "conv_w": L.normal(gen, (*lead, s.d_conv, conv_ch), 0.02, dtype,
                           device),
        "conv_b": torch.zeros((*lead, conv_ch), dtype=dtype, device=device),
        "A_log": torch.log(torch.arange(1, H + 1, **f32)).expand(
            (*lead, H)).clone(),
        "D": torch.ones((*lead, H), **f32),
        "dt_bias": torch.zeros((*lead, H), **f32),
        "norm": L.rmsnorm_init(d_inner, dtype, device, lead),
        "out_proj": L.linear_init(gen, d_inner, d, dtype=dtype, device=device,
                                  lead=lead),
    }


def _split_proj(cfg, zxbcdt):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    G, N = s.n_groups, s.d_state
    H = d_inner // s.head_dim
    cut = 2 * d_inner + 2 * G * N
    return (zxbcdt[..., :d_inner], zxbcdt[..., d_inner:cut],
            zxbcdt[..., cut:], d_inner, G, N, H)


def _causal_conv(xbc, w, b):
    """Depthwise causal conv over (B, L, C), then SiLU; fp32 inside."""
    K = w.shape[0]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for k in range(K):
        out = out + pad[:, k:k + xbc.shape[1]].float() * w[k].float()
    return F.silu(out + b.float()).to(xbc.dtype)


def ssd_chunked(x, dt, A_log, Bmat, Cmat, D, chunk: int):
    """Chunked SSD.  x (B, L, H, P); dt (B, L, H); Bmat/Cmat (B, L, H, N)
    -> y (B, L, H, P) fp32.  L must be a multiple of ``chunk``."""
    Bsz, Lq, H, P = x.shape
    N = Bmat.shape[-1]
    nc = Lq // chunk
    if nc * chunk != Lq:
        raise ValueError("seq len must be divisible by chunk")
    x = x.float() * dt[..., None].float()                   # pre-scale by dt
    a = -torch.exp(A_log.float())[None, None] * dt.float()  # (B, L, H)
    xc = x.reshape(Bsz, nc, chunk, H, P)
    ac = a.reshape(Bsz, nc, chunk, H)
    Bc = Bmat.float().reshape(Bsz, nc, chunk, H, N)
    Cc = Cmat.float().reshape(Bsz, nc, chunk, H, N)

    acum = torch.cumsum(ac, dim=2)                           # (B, nc, Q, H)
    scores = torch.einsum("bnqhd,bnkhd->bnhqk", Cc, Bc)
    decay = (acum[..., :, None, :] - acum[..., None, :, :]).permute(
        0, 1, 4, 2, 3)                                       # (B, nc, H, Q, Q)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    # mask before exp: the upper triangle's exp would overflow
    gate = torch.exp(torch.where(causal, decay,
                                 torch.full_like(decay, -1e30)))
    y_intra = torch.einsum("bnhqk,bnkhp->bnqhp", scores * gate, xc)
    del scores, decay, gate

    a_end = acum[:, :, -1]                                   # (B, nc, H)
    rem = a_end[:, :, None] - acum                           # decay to end
    S = torch.einsum("bnkhd,bnkhp->bnhdp", Bc * torch.exp(rem)[..., None], xc)

    h = torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
    h_prev = []
    for c in range(nc):                                      # state BEFORE chunk
        h_prev.append(h)
        h = h * torch.exp(a_end[:, c])[..., None, None] + S[:, c]
    h_prev = torch.stack(h_prev, dim=1)                      # (B, nc, H, N, P)

    y_inter = torch.einsum("bnqhd,bnhdp->bnqhp", Cc,
                           h_prev) * torch.exp(acum)[..., None]
    y = (y_intra + y_inter).reshape(Bsz, Lq, H, P)
    return y + D.float()[None, None, :, None] * x


def mamba2_forward(p, x, cfg, use_pallas: bool = False):
    s = cfg.ssm
    B, Lq, _ = x.shape
    zxbcdt = L.linear(p["in_proj"], x)
    z, xbc, dt, d_inner, G, N, H = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xs = xbc[..., :d_inner].reshape(B, Lq, H, s.head_dim)
    rep = H // G
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(B, Lq, G, N)
    Cm = xbc[..., d_inner + G * N:].reshape(B, Lq, G, N)
    Bm = Bm.repeat_interleave(rep, dim=2)
    Cm = Cm.repeat_interleave(rep, dim=2)
    dt = F.softplus(dt.float() + p["dt_bias"])
    chunk = min(s.chunk_size, Lq)
    if use_pallas:
        y = ops.ssd_scan(xs, dt, p["A_log"], Bm, Cm, p["D"], chunk)
    else:
        y = ssd_chunked(xs, dt, p["A_log"], Bm, Cm, p["D"], chunk)
    y = y.reshape(B, Lq, d_inner).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z), cfg.norm_eps)
    return L.linear(p["out_proj"], y)


# ---------------------------------------------------------------------------
# O(1) decode
# ---------------------------------------------------------------------------
def mamba2_init_cache(cfg, batch: int, dtype, device=None):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    H = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return {"h": torch.zeros((batch, H, s.d_state, s.head_dim),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dtype,
                                device=device)}


def mamba2_decode(p, x, cache, cfg):
    """x (B, 1, d) -> (y (B, 1, d), new cache)."""
    s = cfg.ssm
    B = x.shape[0]
    zxbcdt = L.linear(p["in_proj"], x)[:, 0]                 # (B, *)
    z, xbc, dt, d_inner, G, N, H = _split_proj(cfg, zxbcdt)
    hist = torch.cat([cache["conv"], xbc[:, None]], dim=1)  # (B, K, C)
    conv = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float())
    xbc = F.silu(conv + p["conv_b"].float()).to(x.dtype)
    xs = xbc[..., :d_inner].reshape(B, H, s.head_dim).float()
    rep = H // G
    Bm = xbc[..., d_inner:d_inner + G * N].reshape(B, G, N).repeat_interleave(
        rep, dim=1).float()
    Cm = xbc[..., d_inner + G * N:].reshape(B, G, N).repeat_interleave(
        rep, dim=1).float()
    dt = F.softplus(dt.float() + p["dt_bias"])               # (B, H)
    decay = torch.exp(-torch.exp(p["A_log"])[None] * dt)     # (B, H)
    xdt = xs * dt[..., None]
    h = cache["h"] * decay[..., None, None] + Bm[..., :, None] * xdt[..., None, :]
    y = torch.einsum("bhd,bhdp->bhp", Cm, h) + p["D"][None, :, None] * xdt
    y = y.reshape(B, 1, d_inner).to(x.dtype)
    y = L.rmsnorm(p["norm"], y * F.silu(z[:, None]), cfg.norm_eps)
    return L.linear(p["out_proj"], y), {"h": h, "conv": hist[:, 1:]}

