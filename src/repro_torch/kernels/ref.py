"""Plain PyTorch versions of the port's kernels (the counterparts of the
JAX package's ``kernels/ref.py:15-84``).

Each repeats its CUDA kernel's arithmetic: fp32 whatever the storage type,
every multiply and add rounded on its own, one rounding to the output type
on write, and the reduces summed client by client in order (QSGD instead
rounds to its operand dtype after every operation, as the reference's jnp
ops do; the threshold select only masks).  So on
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


def sparse_weighted_delta_reduce(values, indices, weights, shape, dtype):
    """Σ_k w_k · scatter(values_k @ indices_k) for one leaf from the stacked
    (K, k) wire pairs of K clients, into a dense tensor of ``shape`` and
    ``dtype``.  The weighted pairs are added into an fp32 zero buffer in
    client-major order and, within a client, in pair order (a duplicate
    index adds again, segment-sum semantics); the buffer is cast once, on
    write.

    ``index_add_`` gives no order among duplicates within one call on the
    card (it adds with atomics), so each client's pairs are applied in
    rounds of unique indices: round r takes every pair that is the r-th
    occurrence of its index.  A top-k wire has unique indices, one round."""
    n = 1
    for d in shape:
        n *= d
    acc_t = acc_dtype(values.dtype)
    out = torch.zeros((n,), dtype=acc_t, device=values.device)
    w = weights.to(acc_t)
    for c in range(values.shape[0]):
        idx = indices[c].long()
        wv = w[c] * values[c].to(acc_t)
        rank = _occurrence_rank(idx)
        for r in range(int(rank.max()) + 1 if idx.numel() else 0):
            sel = rank == r
            out.index_add_(0, idx[sel], wv[sel])
    return out.to(dtype).reshape(shape)


def _occurrence_rank(idx):
    """For each position, how many earlier positions hold the same index."""
    order = torch.sort(idx, stable=True).indices
    sorted_idx = idx[order]
    pos = torch.arange(idx.numel(), device=idx.device)
    new_run = torch.ones_like(sorted_idx, dtype=torch.bool)
    new_run[1:] = sorted_idx[1:] != sorted_idx[:-1]
    run_start = torch.cummax(torch.where(new_run, pos, 0), 0).values
    rank = torch.empty_like(pos)
    rank[order] = pos - run_start
    return rank


def qsgd_quantize(v, u, scale, s):
    """QSGD stochastic uniform quantise-dequantise of a leaf stacked over
    clients: ``v`` and the uniform draw ``u`` are (B, ...), ``scale`` (B,)
    is each row's max magnitude, ``s`` the number of magnitude levels.
    -> (dequantised q, residual v − q).

    Every operation runs in v's dtype, rounding after each as the
    reference's jnp ops do (so bf16 rounds at every step).  The level count
    and the floor 1e-30 are device tensors, not Python scalars: divided by
    a host scalar PyTorch may multiply by its reciprocal instead."""
    shape = (-1,) + (1,) * (v.dim() - 1)
    scale = scale.reshape(shape)
    s_t = torch.full_like(scale, float(s))
    inv = torch.where(scale > 0,
                      s_t / torch.maximum(scale, torch.full_like(scale, 1e-30)),
                      torch.zeros_like(scale))
    y = torch.abs(v) * inv
    lower = torch.floor(y)
    level = lower + (u < (y - lower)).to(v.dtype)
    q = torch.sign(v) * level * (scale / s_t)
    return q, v - q


def topk_threshold_select(v, thresh):
    """Magnitude-threshold select of a leaf stacked over clients (top-k with
    τ = each row's k-th largest |v|, ``thresh`` (B,)).
    -> (selected q, residual v − q)."""
    t = thresh.reshape((-1,) + (1,) * (v.dim() - 1))
    q = torch.where(torch.abs(v) >= t, v, torch.zeros_like(v))
    return q, v - q
