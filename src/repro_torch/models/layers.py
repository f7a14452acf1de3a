"""Functional layers (counterparts of the JAX package's
``models/layers.py``).  Parameters are plain dicts of tensors.

The LM inits draw from a ``torch.Generator`` on the parameters' device
with the reference's distributions: linears uniform ±1/√fan_in
(``layers.py:13-17``), the embedding normal·0.02.  They cannot give
``jax.random``'s numbers, so the parity tests convert the reference's own
init instead (``repro_torch.convert``).  ``lead`` prepends stacking axes:
a run of n identical blocks initialises each leaf once at (n, ...), where
the reference vmaps its init over n keys.  On the ``meta`` device nothing
is drawn, so shapes cost no memory (``registry.count_params``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


# a leaf of more elements than this, kept in a narrower dtype than fp32, is
# drawn in fp32 one slice of its leading axis at a time, so its init peaks
# near its own bytes rather than at twice its fp32 size
SLICED_DRAW = 1 << 26


def uniform(gen, shape, scale, dtype=torch.float32, device=None):
    if dtype != torch.float32 and math.prod(shape) > SLICED_DRAW \
            and len(shape) > 1 and str(device) != "meta":
        t = torch.empty(shape, dtype=dtype, device=device)
        for part in t:
            part.copy_(torch.empty(part.shape, device=device).uniform_(
                -scale, scale, generator=gen))
        return t
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.uniform_(-scale, scale, generator=gen)
    return t.to(dtype)


def normal(gen, shape, std, dtype=torch.float32, device=None):
    t = torch.empty(shape, dtype=torch.float32, device=device)
    if t.device.type != "meta":
        t.normal_(0.0, std, generator=gen)
    return t.to(dtype)


def dense_init(gen, shape, in_axis=-2, dtype=torch.float32, device=None,
               lead=()):
    """Uniform ±1/√fan_in over ``shape`` (the reference's ``_dense_init``,
    ``layers.py:13-17``), with fan_in ``shape[in_axis]`` of the unstacked
    shape (the MoE experts take ``in_axis=1``)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    return uniform(gen, (*lead, *shape), 1.0 / math.sqrt(max(fan_in, 1)),
                   dtype, device)


def linear_init(gen, d_in, d_out, bias=False, dtype=torch.float32,
                device=None, lead=()):
    p = {"w": uniform(gen, (*lead, d_in, d_out), 1.0 / math.sqrt(max(d_in, 1)),
                      dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p, x):
    """x @ w + b with w stored ``(d_in, d_out)``, as in the reference."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def embedding_init(gen, vocab, d_model, dtype=torch.float32, device=None):
    return {"emb": normal(gen, (vocab, d_model), 0.02, dtype, device)}


def embed(p, ids):
    return p["emb"][ids]


def rmsnorm_init(dim, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device)}


def rmsnorm(p, x, eps=1e-5):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * p["scale"].float()).to(dt)


def layernorm_init(dim, dtype=torch.float32, device=None, lead=()):
    return {"scale": torch.ones((*lead, dim), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, dim), dtype=dtype, device=device)}


def layernorm(p, x, eps=1e-5):
    """Statistics in fp32, one cast on write."""
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(dt)


def groupnorm_init(dim, dtype=torch.float32, device=None, lead=()):
    return layernorm_init(dim, dtype, device, lead)


def groupnorm(p, x, groups=32, eps=1e-5):
    """Group norm of NCHW activations as the reference computes it
    (``layers.py:72-86``): ``g = min(groups, c)`` reduced until it divides
    ``c``, statistics in fp32, eps 1e-5.  The reference's reduction axes
    include the group axis, so its mean and variance span every channel
    and position of a sample (one group in effect); the port keeps that."""
    dt = x.dtype
    n, c = x.shape[:2]
    g = min(groups, c)
    while c % g:
        g -= 1
    xg = x.float().reshape(n, g, c // g, *x.shape[2:])
    axes = tuple(range(1, xg.dim()))
    mu = xg.mean(dim=axes, keepdim=True)
    var = ((xg - mu) ** 2).mean(dim=axes, keepdim=True)
    y = ((xg - mu) * torch.rsqrt(var + eps)).reshape(x.shape)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    return (y * p["scale"].reshape(bshape)
            + p["bias"].reshape(bshape)).to(dt)


# --------------------------------------------------------------------------
# Rotary position embeddings (half-split, as the reference).
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, positions: torch.Tensor):
    """positions (...,) -> cos, sin of shape (..., head_dim // 2), fp32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=positions.device) / head_dim))
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x (..., L, H, D); cos/sin broadcastable to (..., L, 1, D/2)."""
    x1, x2 = x.float().chunk(2, dim=-1)
    while cos.dim() < x1.dim():
        cos, sin = cos[..., None, :], sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# SwiGLU MLP.
# --------------------------------------------------------------------------
def mlp_init(gen, d_model, d_ff, dtype=torch.float32, device=None, lead=()):
    return {"gate": linear_init(gen, d_model, d_ff, dtype=dtype,
                                device=device, lead=lead),
            "up": linear_init(gen, d_model, d_ff, dtype=dtype, device=device,
                              lead=lead),
            "down": linear_init(gen, d_ff, d_model, dtype=dtype,
                                device=device, lead=lead)}


def mlp(p, x):
    return linear(p["down"], F.silu(linear(p["gate"], x)) * linear(p["up"], x))


def gelu_mlp_init(gen, d_model, d_ff, dtype=torch.float32, device=None,
                  lead=()):
    return {"fc1": linear_init(gen, d_model, d_ff, bias=True, dtype=dtype,
                               device=device, lead=lead),
            "fc2": linear_init(gen, d_ff, d_model, bias=True, dtype=dtype,
                               device=device, lead=lead)}


def gelu_mlp(p, x):
    # jax.nn.gelu defaults to the tanh approximation; F.gelu to the erf form
    return linear(p["fc2"], F.gelu(linear(p["fc1"], x), approximate="tanh"))
