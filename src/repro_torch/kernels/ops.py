"""Per-leaf public wrappers around the port's kernels (the counterparts of
the JAX package's ``kernels/ops.py:33-97``).

A CUDA tensor launches the Hopper kernel (or the kernel's wrapper raises);
a CPU tensor takes the kernel's plain version from ``ref``.  The device of
the operands is the only thing that picks the path.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.kernels import fedadc_update as _fu
from repro_torch.kernels import ref
from repro_torch.kernels import weighted_reduce as _wr

# the launching wrapper of every kernel, by the name the launch counts use
KERNELS = {
    "fused_axpy": _fu.fused_axpy,
    "local_update": _fu.local_update,
    "server_update": _fu.server_update,
    "weighted_reduce": _wr.weighted_reduce,
}


def launch_counts() -> Dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def fused_axpy(x, y, a):
    """x + a·y on a single leaf."""
    y = y.to(x.dtype)
    if x.device.type == "cpu":
        return ref.fused_axpy(x, y, a)
    return _fu.fused_axpy(x, y, a)


def fedadc_local_update(theta, g, m_bar, eta):
    """θ − η(g + m̄) on a single leaf."""
    g, m_bar = g.to(theta.dtype), m_bar.to(theta.dtype)
    if theta.device.type == "cpu":
        return ref.fedadc_local_update(theta, g, m_bar, eta)
    return _fu.local_update(theta, g, m_bar, eta)


def fedadc_server_update(theta, m, delta_bar, gamma, alpha_eta):
    """(θ', m') fused server update on a single leaf; ``m`` and
    ``delta_bar`` fp32."""
    if theta.device.type == "cpu":
        return ref.fedadc_server_update(theta, m, delta_bar, gamma, alpha_eta)
    return _fu.server_update(theta, m, delta_bar, gamma, alpha_eta)


def weighted_delta_reduce(deltas, weights):
    """Σ_k w_k·Δ_k on a single stacked leaf (leading axis K)."""
    if deltas.device.type == "cpu":
        return ref.weighted_delta_reduce(deltas, weights)
    return _wr.weighted_reduce(deltas, weights)
