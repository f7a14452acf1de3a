"""Plain float32 reference of the Zamba2 hybrid as the port's configuration
defines it (arXiv:2411.15242, with the departures below), and the
benchmark's own weights for it.

Written from the equations in plain PyTorch; it imports nothing of the
program.  Parameters are a flat dict ``{"a/b/c": tensor}`` whose paths
and shapes are the port's parameter tree (``layout``), so the same tensors
can be handed to the program and to this reference.

The stack: ``n_layers`` Mamba2 blocks, with one shared attention block
(one set of weights) applied after every ``shared_attn_every`` of them;
tied embeddings; a final RMSNorm.

* Mamba2 block (arXiv:2405.21060): x + W_out · RMSNorm(y ⊙ SiLU(z)), with
  [z, xBC, dt] = W_in · RMSNorm(x); xBC through a causal depthwise
  convolution of width ``d_conv`` and SiLU; dt = softplus(dt + dt_bias);
  the selective state space h_t = exp(dt_t·A) h_{t-1} + B_t (dt_t x_t)ᵀ,
  y_t = C_t h_t + D·(dt_t x_t), A = −exp(A_log).  The scan is the chunked
  dual form of the Mamba-2 paper's listing ("ssd_minimal_discrete"), with
  its stable segment sums.
* Shared block: pre-norm causal multi-head attention with rotary
  positions (half split, θ 10000) and a SwiGLU MLP of width ``d_ff``.

Departures from the paper, as the port's configuration has them: the
skip term is D times the dt-scaled input (D·dt·x, not D·x); the shared
block reads the residual stream alone (no concatenation with the original
embeddings) and has no per-invocation LoRA adapters; there is one shared
block, not two alternating.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MAMBA, SHARED = "mamba2", "shared_attn"


def pattern(cfg) -> List[str]:
    out = []
    for i in range(cfg["n_layers"]):
        out.append(MAMBA)
        if (i + 1) % cfg["shared_attn_every"] == 0:
            out.append(SHARED)
    return out


def runs(cfg) -> List[Tuple[str, int, int]]:
    """-> [(kind, run index, layers)]: consecutive Mamba2 blocks form one
    run (stacked weights), each shared block a run of its own."""
    out: List[Tuple[str, int, int]] = []
    for kind in pattern(cfg):
        if out and out[-1][0] == MAMBA and kind == MAMBA:
            out[-1] = (MAMBA, out[-1][1], out[-1][2] + 1)
        else:
            out.append((kind, len(out), 1))
    return out


def _dims(cfg):
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    H = di // s["head_dim"]
    return di, H, s["n_groups"], s["d_state"], s["head_dim"]


def layout(cfg) -> Dict[str, Tuple[tuple, str, float]]:
    """path -> (shape, init, scale): ``uniform`` on ±scale, ``normal`` with
    std scale, or ``const`` (every element scale; ``arange_log``: log 1..H
    along the last axis)."""
    d, V = cfg["d_model"], cfg["vocab_size"]
    di, H, G, N, _ = _dims(cfg)
    K = cfg["ssm"]["d_conv"]
    C = di + 2 * G * N
    hd = cfg["head_dim"]
    nq, nkv = cfg["n_heads"] * hd, cfg["n_kv_heads"] * hd
    ff = cfg["d_ff"]
    out = {"embed/emb": ((V, d), "normal", 0.02)}
    for kind, ri, n in runs(cfg):
        if kind != MAMBA:
            continue
        r = f"runs/{ri}"
        out.update({
            f"{r}/ln/scale": ((n, d), "const", 1.0),
            f"{r}/mix/in_proj/w": ((n, d, 2 * di + 2 * G * N + H), "uniform",
                                   1 / math.sqrt(d)),
            f"{r}/mix/conv_w": ((n, K, C), "normal", 0.02),
            f"{r}/mix/conv_b": ((n, C), "const", 0.0),
            f"{r}/mix/A_log": ((n, H), "arange_log", 0.0),
            f"{r}/mix/D": ((n, H), "const", 1.0),
            f"{r}/mix/dt_bias": ((n, H), "const", 0.0),
            f"{r}/mix/norm/scale": ((n, di), "const", 1.0),
            f"{r}/mix/out_proj/w": ((n, di, d), "uniform", 1 / math.sqrt(di)),
        })
    out.update({
        "shared_attn/ln1/scale": ((d,), "const", 1.0),
        "shared_attn/ln2/scale": ((d,), "const", 1.0),
        "shared_attn/attn/wq/w": ((d, nq), "uniform", 1 / math.sqrt(d)),
        "shared_attn/attn/wk/w": ((d, nkv), "uniform", 1 / math.sqrt(d)),
        "shared_attn/attn/wv/w": ((d, nkv), "uniform", 1 / math.sqrt(d)),
        "shared_attn/attn/wo/w": ((nq, d), "uniform", 1 / math.sqrt(nq)),
        "shared_attn/mlp/gate/w": ((d, ff), "uniform", 1 / math.sqrt(d)),
        "shared_attn/mlp/up/w": ((d, ff), "uniform", 1 / math.sqrt(d)),
        "shared_attn/mlp/down/w": ((ff, d), "uniform", 1 / math.sqrt(ff)),
        "final_norm/scale": ((d,), "const", 1.0),
    })
    return out


def make_params(cfg, seed: int, device):
    """The benchmark's weights from ``seed``, on ``device``: every uniform
    leaf a view of one draw, every normal leaf a view of another (the
    port's distributions: linears ±1/√fan_in, embedding and convolution
    N(0, 0.02²), A_log = log 1..H, D = 1, the rest 0 or 1)."""
    lay = layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    bufs = {}
    for kind in ("uniform", "normal"):
        n = sum(math.prod(s) for s, k, _ in lay.values() if k == kind)
        b = torch.empty(n, dtype=torch.float32, device=device)
        if kind == "uniform":
            b.uniform_(-1.0, 1.0, generator=gen)
        else:
            b.normal_(0.0, 1.0, generator=gen)
        bufs[kind] = b
    offs = {"uniform": 0, "normal": 0}
    out = {}
    for path, (shape, kind, scale) in lay.items():
        if kind in bufs:
            n = math.prod(shape)
            t = bufs[kind][offs[kind]:offs[kind] + n].view(shape).mul_(scale)
            offs[kind] += n
        elif kind == "arange_log":
            t = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                       device=device)).expand(shape).clone()
        else:
            t = torch.full(shape, scale, dtype=torch.float32, device=device)
        out[path] = t
    return out


# ---------------------------------------------------------------------------
# the forward pass, float32
# ---------------------------------------------------------------------------
def rmsnorm(x, scale, eps):
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * scale


def segsum(x):
    """x (..., T) -> (..., T, T): out[i, j] = Σ_{k=j+1..i} x_k for j ≤ i,
    −inf above the diagonal (Mamba-2's stable segment sum)."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), -1)
    x = x.masked_fill(~below, 0.0)
    s = torch.cumsum(x, dim=-2)
    keep = torch.tril(torch.ones(T, T, dtype=torch.bool, device=x.device), 0)
    return s.masked_fill(~keep, -torch.inf)


def ssd(X, A, B, C, chunk: int):
    """X (b, L, h, p) dt-scaled input, A (b, L, h) dt-scaled decay rates,
    B, C (b, L, h, n) -> y (b, L, h, p), zero initial state."""
    b, L, h, p = X.shape
    c = L // chunk
    X, B, C = (t.reshape(b, c, chunk, *t.shape[2:]) for t in (X, B, C))
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # b h c l
    A_cum = torch.cumsum(A, dim=-1)
    Ldec = torch.exp(segsum(A))                              # b h c l s
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, Ldec, X)
    decay_states = torch.exp(A_cum[..., -1:] - A_cum)        # b h c l
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cum[..., -1], (1, 0))))
    states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", C, states,
                         torch.exp(A_cum))
    return (y_diag + y_off).reshape(b, L, h, p)


def mamba_block(x, P, cfg):
    di, H, G, N, hp = _dims(cfg)
    B_, L, _ = x.shape
    eps = cfg["norm_eps"]
    zxbcdt = rmsnorm(x, P["ln/scale"], eps) @ P["mix/in_proj/w"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    K = P["mix/conv_w"].shape[0]
    w = P["mix/conv_w"].t()[:, None, :]                      # (C, 1, K)
    xbc = F.conv1d(F.pad(xbc.transpose(1, 2), (K - 1, 0)), w,
                   P["mix/conv_b"], groups=w.shape[0]).transpose(1, 2)
    xbc = F.silu(xbc)
    xs = xbc[..., :di].reshape(B_, L, H, hp)
    rep = H // G
    Bm = xbc[..., di:di + G * N].reshape(B_, L, G, N).repeat_interleave(rep, 2)
    Cm = xbc[..., di + G * N:].reshape(B_, L, G, N).repeat_interleave(rep, 2)
    dt = F.softplus(dt + P["mix/dt_bias"])                   # (B, L, H)
    A = -torch.exp(P["mix/A_log"])
    X = xs * dt[..., None]
    y = ssd(X, A * dt, Bm, Cm, min(cfg["ssm"]["chunk_size"], L))
    y = y + P["mix/D"][:, None] * X
    y = rmsnorm(y.reshape(B_, L, di) * F.silu(z), P["mix/norm/scale"], eps)
    return x + y @ P["mix/out_proj/w"]


def rope(x, theta):
    """x (B, L, h, d): rotary positions 0..L-1, halves rotated."""
    L, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(L, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def shared_block(x, P, cfg):
    B_, L, _ = x.shape
    hd, nh, nkv = cfg["head_dim"], cfg["n_heads"], cfg["n_kv_heads"]
    eps = cfg["norm_eps"]
    h = rmsnorm(x, P["ln1/scale"], eps)
    q = rope((h @ P["attn/wq/w"]).reshape(B_, L, nh, hd), cfg["rope_theta"])
    k = rope((h @ P["attn/wk/w"]).reshape(B_, L, nkv, hd), cfg["rope_theta"])
    v = (h @ P["attn/wv/w"]).reshape(B_, L, nkv, hd)
    k = k.repeat_interleave(nh // nkv, 2)
    v = v.repeat_interleave(nh // nkv, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    causal = torch.tril(torch.ones(L, L, dtype=torch.bool, device=x.device))
    a = torch.softmax(s.masked_fill(~causal, -torch.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", a, v).reshape(B_, L, nh * hd)
    x = x + o @ P["attn/wo/w"]
    h2 = rmsnorm(x, P["ln2/scale"], eps)
    return x + (F.silu(h2 @ P["mlp/gate/w"]) * (h2 @ P["mlp/up/w"])) \
        @ P["mlp/down/w"]


def _sub(params, prefix, i=None):
    n = len(prefix) + 1
    return {k[n:]: (v if i is None else v[i]) for k, v in params.items()
            if k.startswith(prefix + "/")}


def loss(params, batch, cfg, remat: bool = True):
    """Mean next-token cross-entropy: position t's logits against label
    t + 1, positions whose label is negative left out."""
    tokens, labels = batch["tokens"], batch["labels"]
    x = params["embed/emb"][tokens.long()]

    def wrap(fn):
        if not remat:
            return fn
        return lambda *a: checkpoint(fn, *a, use_reentrant=False)
    run_mamba, run_shared = wrap(mamba_block), wrap(shared_block)
    for kind, ri, n in runs(cfg):
        if kind == SHARED:
            x = run_shared(x, _sub(params, "shared_attn"), cfg)
            continue
        for i in range(n):
            x = run_mamba(x, _sub(params, f"runs/{ri}", i), cfg)
    x = rmsnorm(x, params["final_norm/scale"], cfg["norm_eps"])
    logits = (x @ params["embed/emb"].t())[:, :-1]
    tgt = labels[:, 1:].long()
    mask = (tgt >= 0).to(logits.dtype)
    gold = torch.gather(logits, -1, tgt.clamp_min(0)[..., None])[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)
