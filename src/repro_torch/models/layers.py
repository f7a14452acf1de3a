"""Functional layers of the paper's vision models (counterparts of the JAX
package's ``models/layers.py``).  Parameters are plain dicts of tensors."""
from __future__ import annotations

import torch


def linear(p, x):
    """x @ w + b with w stored ``(d_in, d_out)``, as in the reference."""
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def groupnorm_init(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


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
