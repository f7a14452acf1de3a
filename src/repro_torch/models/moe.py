"""Mixture-of-Experts FFN (counterpart of the JAX package's
``models/moe.py``): DeepSeek-V3's 256 routed experts top-8 with a shared
expert, Llama-4's 16 top-1 with a shared expert.

Dispatch is the reference's capacity-based scatter and gather: each
(token, choice) assignment takes a position within its expert by a stable
sort of the expert ids (token order kept), assignments past the capacity
go to an overflow row that is cut off, the kept ones are scattered into an
(E, cap + 1, d) buffer, the experts run as batched products over (E, cap,
d), and the outputs are gathered back and weighted.  No (T, E, cap)
one-hot tensor forms.  The router runs in fp32 and its weight stays fp32
at any parameter dtype.

Ties in the router: ``torch.topk`` does not promise an order for equal
probabilities, where ``jax.lax.top_k`` takes the lower index first.  The
parity tests check that their routers have no tie at the top-k boundary.

The reference pins the token and expert buffers to mesh axes
(``_constrain``); on one card there is no mesh, so the port has no
counterpart.  The expert products are plain ``torch.bmm``: the reference
computes them with ``einsum`` outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


def moe_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    m = cfg.moe
    d, E, f = cfg.d_model, m.n_experts, m.d_ff_expert
    kw = dict(in_axis=1, dtype=dtype, device=device, lead=lead)
    p = {"router": L.linear_init(gen, d, E, dtype=torch.float32,
                                 device=device, lead=lead),
         "experts": {"gate": L.dense_init(gen, (E, d, f), **kw),
                     "up": L.dense_init(gen, (E, d, f), **kw),
                     "down": L.dense_init(gen, (E, f, d), **kw)}}
    if m.n_shared_experts > 0:
        p["shared"] = L.mlp_init(gen, d, f * m.n_shared_experts, dtype,
                                 device, lead)
    return p


def capacity(cfg, n_tokens: int) -> int:
    """Each expert's slots for a call of ``n_tokens`` tokens (``:63``)."""
    m = cfg.moe
    return int(max(1, (n_tokens * m.top_k * m.capacity_factor)
                   // m.n_experts))


def route(p, xt, cfg):
    """The router and the dispatch plan of tokens ``xt`` (T, d) ->
    (flat_e, flat_w, pos_in_e, keep, aux): each (token, choice)
    assignment's expert, weight and position within its expert (``cap``,
    the overflow slot, where dropped), and the load-balance loss."""
    m = cfg.moe
    T = xt.shape[0]
    probs = torch.softmax(L.linear(p["router"], xt.float()), dim=-1)
    topw, topi = torch.topk(probs, m.top_k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    flat_e, flat_w = topi.reshape(-1), topw.reshape(-1)
    cap = capacity(cfg, T)
    # bincount's counts, as an integer index_add_ (exact in any order),
    # which also runs on the meta device (the dry-run's shape pass)
    counts = torch.zeros((m.n_experts,), dtype=flat_e.dtype,
                         device=xt.device).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    ce = counts.float() / (T * m.top_k)
    aux = m.router_aux_coef * m.n_experts * torch.sum(probs.mean(0) * ce)
    # position within the expert: the stable sort keeps token order
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(flat_e, stable=True)
    pos_sorted = torch.arange(flat_e.numel(), device=xt.device) \
        - starts[flat_e[order]]
    pos_in_e = torch.empty_like(flat_e).scatter_(0, order, pos_sorted)
    keep = pos_in_e < cap
    return flat_e, flat_w, torch.where(keep, pos_in_e, cap), keep, aux


def moe_apply(p, x, cfg):
    """x (B, L, d) -> (y (B, L, d), aux loss)."""
    m = cfg.moe
    B, Lq, d = x.shape
    T = B * Lq
    xt = x.reshape(T, d)
    flat_e, flat_w, pos_in_e, keep, aux = route(p, xt, cfg)
    cap = capacity(cfg, T)
    xin = torch.repeat_interleave(xt, m.top_k, dim=0)
    # only the overflow row takes more than one write, each of zeros
    buf = torch.zeros((m.n_experts, cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.index_put_((flat_e, pos_in_e), xin * keep[:, None].to(x.dtype),
                   accumulate=True)
    buf = buf[:, :cap]
    ew = p["experts"]
    h = torch.bmm(buf, ew["gate"].to(x.dtype))
    u = torch.bmm(buf, ew["up"].to(x.dtype))
    out = torch.bmm(F.silu(h) * u, ew["down"].to(x.dtype))   # (E, cap, d)
    out = F.pad(out, (0, 0, 0, 1))                           # overflow row
    gathered = out[flat_e, pos_in_e] \
        * (flat_w * keep)[:, None].to(x.dtype)
    y = gathered.reshape(T, m.top_k, d).sum(1)
    if "shared" in p:
        y = y + L.mlp(p["shared"], xt)
    return y.reshape(B, Lq, d), aux
