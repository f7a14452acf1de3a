"""Pluggable server aggregators, dense half (counterpart of the JAX
package's ``federated/aggregation.py``; the sparse-wire half comes with the
wire slice).

Every strategy's server step consumes Δ̄ = Σ_i w_i·Δ_i / Σ_i w_i over the
round's client deltas.  The weight families:

* ``uniform``  — the paper's 1/|S| mean (FedAvg/FedADC default).
* ``examples`` — w_i ∝ n_i local examples.
* ``drag``     — DRAG-style divergence-adaptive weights,
  w_i = exp(−λ·(1 − cos(Δ_i, ref))), with the server momentum as the
  reference direction when the strategy keeps one, else the round mean.

``weighted_mean`` is the one reduction everything funnels through; leaf by
leaf it runs the weighted-delta-reduce kernel (its plain version on CPU).
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as T
from repro_torch.kernels import ops

_EPS = 1e-12

KNOWN_AGGREGATORS = ("uniform", "examples", "drag")


def _leading_dim(deltas) -> int:
    return T.leaves(deltas)[0].shape[0]


def cosine_divergence(delta, ref):
    """1 − cos(Δ, ref) over trees; 1.0 (neutral) when ref is ~zero."""
    num = T.dot(delta, ref)
    den = torch.sqrt(T.sq_norm(delta) * T.sq_norm(ref) + _EPS)
    return 1.0 - num / torch.clamp(den, min=_EPS)


def reference_direction(server_state):
    """The DRAG reference direction: the server momentum when the strategy
    keeps one, ``None`` otherwise (``drag_weights`` then falls back to the
    round mean)."""
    return server_state.get("m") if server_state is not None else None


def drag_weights(deltas, ref=None, lam: float = 4.0):
    """Divergence-adaptive weights over stacked deltas (leading axis K)."""
    if ref is None:
        ref = T.tree_map(lambda d: torch.mean(d, 0), deltas)
    div = torch.func.vmap(lambda d: cosine_divergence(d, ref))(deltas)
    return torch.exp(-lam * div)


def compute_weights(name: str, deltas, n_examples=None, ref=None,
                    lam: float = 4.0):
    """Unnormalised aggregation weights (K,) fp32 for stacked deltas."""
    K = _leading_dim(deltas)
    device = T.leaves(deltas)[0].device
    if name == "uniform":
        return torch.ones((K,), dtype=torch.float32, device=device)
    if name == "examples":
        if n_examples is None:
            raise ValueError("aggregator='examples' needs per-client counts")
        return torch.as_tensor(n_examples, dtype=torch.float32, device=device)
    if name == "drag":
        return drag_weights(deltas, ref=ref, lam=lam)
    raise ValueError(f"unknown aggregator {name!r}; "
                     f"known: {', '.join(KNOWN_AGGREGATORS)}")


def weighted_mean(deltas, weights):
    """Σ_i w_i·Δ_i / Σ_i w_i over a stacked tree (leading axis K).

    The reduction accumulates in fp32 whatever the delta dtype and casts on
    write: summing bf16 deltas in bf16 loses the aggregate to rounding as K
    grows."""
    wn = weights.float() / torch.clamp(torch.sum(weights), min=_EPS)
    return T.tree_map(lambda d: ops.weighted_delta_reduce(d, wn), deltas)
