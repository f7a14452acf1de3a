"""xLSTM blocks (counterpart of the JAX package's ``models/xlstm.py``,
arXiv:2405.04517): the mLSTM (matrix memory) in its stabilised parallel
form, and the sLSTM (scalar memory with recurrent gate connections), a
true sequential recurrence: a Python loop over the sequence where the
reference runs ``lax.scan``.

Both carry their recurrent state in fp32 whatever the parameter dtype.
The sLSTM's output norm is the port's ``groupnorm``: like the reference's,
its statistics span every channel (one group in effect) and, in the
full-sequence forward, every position of the sequence, where a decode step
sees only its own position.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    d = cfg.d_model
    d_inner = cfg.ssm.expand * d
    H = cfg.n_heads
    kw = dict(dtype=dtype, device=device, lead=lead)
    return {
        "wu": L.linear_init(gen, d, d_inner, **kw),
        "wz": L.linear_init(gen, d, d_inner, **kw),
        "conv_w": L.normal(gen, (*lead, cfg.ssm.d_conv, d_inner), 0.02, dtype,
                           device),
        "conv_b": torch.zeros((*lead, d_inner), dtype=dtype, device=device),
        "wq": L.linear_init(gen, d_inner, d_inner, **kw),
        "wk": L.linear_init(gen, d_inner, d_inner, **kw),
        "wv": L.linear_init(gen, d_inner, d_inner, **kw),
        "w_if": L.linear_init(gen, d_inner, 2 * H, bias=True, **kw),
        "norm": L.rmsnorm_init(d_inner, dtype, device, lead),
        "down": L.linear_init(gen, d_inner, d, **kw),
    }


def _mlstm_parallel(q, k, v, logi, logf):
    """The stabilised parallel mLSTM.  q, k, v (B, L, H, P); logi, logf
    (B, L, H) -> (B, L, H, P) fp32."""
    B, Lq, H, P = q.shape
    q, k, v = q.float(), k.float(), v.float()
    Fc = torch.cumsum(F.logsigmoid(logf.float()), dim=1)
    # D[i, j] = F_i - F_j + logi_j for j <= i
    Dmat = Fc[:, :, None] - Fc[:, None] + logi.float()[:, None]
    causal = torch.tril(torch.ones((Lq, Lq), dtype=torch.bool,
                                   device=q.device))
    Dmat = Dmat.masked_fill(~causal[None, :, :, None], float("-inf"))
    m = Dmat.amax(dim=2, keepdim=True)                      # stabiliser
    w = torch.einsum("bihp,bjhp->bijh", q, k) * (P ** -0.5) \
        * torch.exp(Dmat - m)
    denom = torch.maximum(w.sum(dim=2, keepdim=True).abs(), torch.exp(-m))
    return torch.einsum("bijh,bjhp->bihp", w / denom, v)


def mlstm_forward(p, x, cfg):
    B, Lq, _ = x.shape
    d_inner = cfg.ssm.expand * cfg.d_model
    H = cfg.n_heads
    P = d_inner // H
    u = L.linear(p["wu"], x)
    z = L.linear(p["wz"], x)
    K = p["conv_w"].shape[0]
    pad = F.pad(u, (0, 0, K - 1, 0))
    c = sum(pad[:, k:k + Lq].float() * p["conv_w"][k].float()
            for k in range(K))
    c = F.silu(c + p["conv_b"].float()).to(x.dtype)
    q = L.linear(p["wq"], c).reshape(B, Lq, H, P)
    k = L.linear(p["wk"], c).reshape(B, Lq, H, P)
    v = L.linear(p["wv"], u).reshape(B, Lq, H, P)
    logi, logf = L.linear(p["w_if"], u).float().chunk(2, dim=-1)
    y = _mlstm_parallel(q, k, v, logi, logf).reshape(B, Lq, d_inner)
    y = L.rmsnorm(p["norm"], y.to(x.dtype), cfg.norm_eps) * F.silu(z)
    return L.linear(p["down"], y)


def mlstm_init_cache(cfg, batch, dtype, device=None):
    d_inner = cfg.ssm.expand * cfg.d_model
    H = cfg.n_heads
    P = d_inner // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, P, P), **f32),      # matrix memory
            "n": torch.zeros((batch, H, P), **f32),
            "m": torch.full((batch, H), -1e30, **f32),
            "conv": torch.zeros((batch, cfg.ssm.d_conv - 1, d_inner),
                                dtype=dtype, device=device)}


def mlstm_decode(p, x, cache, cfg):
    B = x.shape[0]
    d_inner = cfg.ssm.expand * cfg.d_model
    H = cfg.n_heads
    P = d_inner // H
    u = L.linear(p["wu"], x)[:, 0]                          # (B, d_inner)
    z = L.linear(p["wz"], x)[:, 0]
    hist = torch.cat([cache["conv"], u[:, None].to(cache["conv"].dtype)], 1)
    c = torch.einsum("bkc,kc->bc", hist.float(), p["conv_w"].float())
    c = F.silu(c + p["conv_b"].float()).to(x.dtype)
    q = L.linear(p["wq"], c).reshape(B, H, P).float()
    k = L.linear(p["wk"], c).reshape(B, H, P).float() * (P ** -0.5)
    v = L.linear(p["wv"], u).reshape(B, H, P).float()
    logi, logf = L.linear(p["w_if"], u).float().chunk(2, dim=-1)  # (B, H)
    logf = F.logsigmoid(logf)
    m_new = torch.maximum(logf + cache["m"], logi)
    fi = torch.exp(logf + cache["m"] - m_new)
    ii = torch.exp(logi - m_new)
    C = cache["C"] * fi[..., None, None] \
        + ii[..., None, None] * torch.einsum("bhp,bhr->bhpr", v, k)
    n = cache["n"] * fi[..., None] + ii[..., None] * k
    num = torch.einsum("bhpr,bhr->bhp", C, q)
    den = torch.maximum(torch.einsum("bhr,bhr->bh", n, q).abs(),
                        torch.exp(-m_new))
    y = (num / den[..., None]).reshape(B, 1, d_inner).to(x.dtype)
    y = L.rmsnorm(p["norm"], y, cfg.norm_eps) * F.silu(z[:, None])
    return L.linear(p["down"], y), {"C": C, "n": n, "m": m_new,
                                    "conv": hist[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
GATES = ("wx_z", "wx_i", "wx_f", "wx_o")


def slstm_init(gen, cfg, dtype=torch.float32, device=None, lead=()):
    d = cfg.d_model
    H = cfg.n_heads
    P = d // H
    kw = dict(bias=True, dtype=dtype, device=device, lead=lead)
    p = {g: L.linear_init(gen, d, d, **kw) for g in GATES}
    p["r"] = L.normal(gen, (*lead, 4, H, P, P), P ** -0.5, dtype, device)
    p["norm"] = L.groupnorm_init(d, dtype, device, lead)
    p["ffn"] = L.mlp_init(gen, d, int(d * 4 / 3), dtype, device, lead)
    p["ffn_norm"] = L.rmsnorm_init(d, dtype, device, lead)
    return p


def _slstm_cell(r, xg, state, H, P):
    """One step.  xg: the four input projections, each (B, d); state (c,
    n, h, m), each (B, H, P) but m (B, H), the stabiliser the heads'
    units share."""
    c, n, h, m = state
    z_in, i_in, f_in, o_in = (g.float() for g in xg)
    B = z_in.shape[0]
    rec = torch.einsum("ghpq,bhq->gbhp", r, h.reshape(B, H, P))
    shp = (B, H, P)
    z = torch.tanh(z_in.reshape(shp) + rec[0])
    logi = i_in.reshape(shp) + rec[1]
    logf = F.logsigmoid(f_in.reshape(shp) + rec[2])
    o = torch.sigmoid(o_in.reshape(shp) + rec[3])
    m_new = torch.maximum(logf + m[..., None], logi).amax(-1)
    fi = torch.exp(logf + m[..., None] - m_new[..., None])
    ii = torch.exp(logi - m_new[..., None])
    c_new = fi * c + ii * z
    n_new = fi * n + ii
    return c_new, n_new, o * c_new / n_new.clamp_min(1e-6), m_new


def _slstm_out(p, h, x_dtype, cfg):
    """The norm and feed-forward after the cell: h (B, L, d) -> (B, L, d).
    The port's groupnorm takes channels on axis 1."""
    y = h.to(x_dtype).transpose(1, 2)
    y = L.groupnorm(p["norm"], y, groups=cfg.n_heads,
                    eps=cfg.norm_eps).transpose(1, 2)
    return y + L.mlp(p["ffn"], L.rmsnorm(p["ffn_norm"], y, cfg.norm_eps))


def slstm_forward(p, x, cfg):
    B, Lq, d = x.shape
    H = cfg.n_heads
    P = d // H
    xg = [L.linear(p[g], x) for g in GATES]
    r = p["r"].float()
    zeros = torch.zeros((B, H, P), dtype=torch.float32, device=x.device)
    state = (zeros, zeros, zeros,
             torch.full((B, H), -1e30, dtype=torch.float32, device=x.device))
    hs = []
    for t in range(Lq):
        state = _slstm_cell(r, [g[:, t] for g in xg], state, H, P)
        hs.append(state[2])
    return _slstm_out(p, torch.stack(hs, 1).reshape(B, Lq, d), x.dtype, cfg)


def slstm_init_cache(cfg, batch, dtype, device=None):
    H = cfg.n_heads
    P = cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"c": torch.zeros((batch, H, P), **f32),
            "n": torch.zeros((batch, H, P), **f32),
            "h": torch.zeros((batch, H, P), **f32),
            "m": torch.full((batch, H), -1e30, **f32)}


def slstm_decode(p, x, cache, cfg):
    B, _, d = x.shape
    H = cfg.n_heads
    xg = [L.linear(p[g], x)[:, 0] for g in GATES]
    c, n, h, m = _slstm_cell(p["r"].float(), xg,
                             (cache["c"], cache["n"], cache["h"], cache["m"]),
                             H, d // H)
    y = _slstm_out(p, h.reshape(B, 1, d), x.dtype, cfg)
    return y, {"c": c, "n": n, "h": h, "m": m}
