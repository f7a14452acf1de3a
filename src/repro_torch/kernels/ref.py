"""Plain PyTorch versions of the port's kernels (the counterparts of the
JAX package's ``kernels/ref.py:15-38``).

Each repeats its CUDA kernel's arithmetic: fp32 whatever the storage type,
every multiply and add rounded on its own, one rounding to the output type
on write, and the weighted reduce summed client by client in order.  So on
the same inputs a kernel and its plain version agree bit for bit.  The CPU
runs these; on the card they are the yardstick the kernels are held to.
"""
from __future__ import annotations

import torch


def acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """At least fp32, never a downcast (float64 stays float64)."""
    return torch.promote_types(dtype, torch.float32)


def fused_axpy(x, y, a):
    """x + a·y."""
    acc = acc_dtype(x.dtype)
    return (x.to(acc) + a * y.to(acc)).to(x.dtype)


def fedadc_local_update(theta, g, m_bar, eta):
    """Heavy-ball embedded step (Alg. 3 blue): θ − η(g + m̄)."""
    acc = acc_dtype(theta.dtype)
    return (theta.to(acc) - eta * (g.to(acc) + m_bar.to(acc))).to(theta.dtype)


def fedadc_server_update(theta, m, delta_bar, gamma, alpha_eta):
    """Alg. 3 lines 17+19: m' = Δ̄ + γ·m ; θ' = θ − αη·m'.  -> (θ', m').
    ``m``/``delta_bar`` stay in their (fp32) dtype; θ' takes θ's dtype."""
    m_new = delta_bar + gamma * m
    acc = acc_dtype(theta.dtype)
    return (theta.to(acc) - alpha_eta * m_new).to(theta.dtype), m_new


def weighted_delta_reduce(deltas, weights):
    """Σ_k w_k·Δ_k for one stacked tensor (K, ...), summed in at least fp32
    in client order and cast back to the delta dtype on write."""
    acc_t = acc_dtype(deltas.dtype)
    w = weights.to(acc_t)
    acc = torch.zeros(deltas.shape[1:], dtype=acc_t, device=deltas.device)
    for k in range(deltas.shape[0]):
        acc = acc + w[k] * deltas[k].to(acc_t)
    return acc.to(deltas.dtype)
