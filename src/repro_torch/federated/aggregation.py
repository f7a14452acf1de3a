"""Pluggable server aggregators (counterpart of the JAX package's
``federated/aggregation.py``).

Every strategy's server step consumes Δ̄ = Σ_i w_i·Δ_i / Σ_i w_i over the
round's client deltas.  The weight families:

* ``uniform``  — the paper's 1/|S| mean (FedAvg/FedADC default).
* ``examples`` — w_i ∝ n_i local examples.
* ``drag``     — DRAG-style divergence-adaptive weights,
  w_i = exp(−λ·(1 − cos(Δ_i, ref))), with the server momentum as the
  reference direction when the strategy keeps one, else the round mean.

``weighted_mean`` is the one reduction dense deltas funnel through; it
runs the weighted-delta-reduce kernel over all leaves in one call (its
plain version leaf by leaf on CPU).  A stacked SparseLeaf wire (the
sparse-native top-k uplink) takes ``sparse_weighted_mean`` instead, the
sparse-reduce kernel at K·k cost over all leaves in one call, and its
norms, dots and DRAG weights are read off the wire without densifying.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as T
from repro_torch.federated.compression import is_sparse_leaf, is_sparse_tree
from repro_torch.kernels import ops

_EPS = 1e-12

KNOWN_AGGREGATORS = ("uniform", "examples", "drag")


def _first_tensor(deltas):
    """The first leaf's tensor (a sparse leaf's values)."""
    first = T.leaves(deltas)[0]
    return first.values if is_sparse_leaf(first) else first


def _leading_dim(deltas) -> int:
    return _first_tensor(deltas).shape[0]


def cosine_divergence(delta, ref):
    """1 − cos(Δ, ref) over trees; 1.0 (neutral) when ref is ~zero."""
    num = T.dot(delta, ref)
    den = torch.sqrt(T.sq_norm(delta) * T.sq_norm(ref) + _EPS)
    return 1.0 - num / torch.clamp(den, min=_EPS)


# ---------------------------------------------------------------------------
# sparse-wire primitives: norms / dots / means at K·k cost, never building a
# per-client dense tree
# ---------------------------------------------------------------------------
def sparse_sq_norms(wire):
    """‖Δ_i‖² from the SparseLeaf wire alone: Σ v² in fp32, (K,) for a
    client-stacked wire.  Assumes unique indices per client, as top-k
    wires have."""
    return sum(torch.sum(torch.square(w.values.float()), dim=-1)
               for w in T.leaves(wire))


def sparse_dot_dense(wire, dense):
    """⟨Δ_i, ref⟩ against a dense tree at k cost: gather ref at the wire
    indices.  (K,) for a stacked wire."""
    def leaf(w, d):
        flat = d.reshape(-1).float()
        return torch.sum(w.values.float() * flat[w.indices.long()], dim=-1)
    return sum(T.leaves(T.tree_map(leaf, wire, dense)))


def sparse_cosine_divergence(wire, ref):
    """1 − cos(Δ, ref) with Δ read straight off the sparse wire."""
    num = sparse_dot_dense(wire, ref)
    den = torch.sqrt(sparse_sq_norms(wire) * T.sq_norm(ref).float() + _EPS)
    return 1.0 - num / torch.clamp(den, min=_EPS)


def sparse_weighted_mean(wire, weights, like):
    """Σ_i w_i·Δ_i / Σ_i w_i where the stacked deltas are SparseLeaf wires:
    the sparse-reduce kernel builds every dense leaf directly at K·k cost,
    one call for the whole tree.  ``like`` gives the dense leaf shapes and
    dtypes.  fp32 accumulation, cast on write, as in ``weighted_mean``."""
    wn = weights.float() / torch.clamp(torch.sum(weights), min=_EPS)
    return ops.sparse_weighted_delta_reduce_tree(
        T.tree_map(lambda w: w.values, wire),
        T.tree_map(lambda w: w.indices, wire), wn, like)


def reference_direction(server_state):
    """The DRAG reference direction: the server momentum when the strategy
    keeps one, ``None`` otherwise (``drag_weights`` then falls back to the
    round mean)."""
    return server_state.get("m") if server_state is not None else None


def streaming_weight(delta, ref, name: str, lam: float):
    """One client's scalar weight, computable without the other deltas
    (the pod engine's client-serial form); ``delta`` is one client's tree,
    dense or a SparseLeaf wire.

    ``examples`` is uniform here by construction: every pod-engine client
    contributes the same (H, b, L) token budget.  ``drag`` needs a momentum
    reference: the caller rejects momentum-less strategies up front (in
    streaming form there is no round mean to fall back on)."""
    if name not in KNOWN_AGGREGATORS:
        raise ValueError(f"unknown aggregator {name!r}; "
                         f"known: {', '.join(KNOWN_AGGREGATORS)}")
    if name == "drag":
        if ref is None:
            raise ValueError("streaming drag weights need a momentum "
                             "reference direction")
        if is_sparse_tree(delta):
            return torch.exp(-lam * sparse_cosine_divergence(delta, ref))
        return torch.exp(-lam * cosine_divergence(delta, ref))
    return torch.ones((), dtype=torch.float32,
                      device=_first_tensor(delta).device)


def drag_weights(deltas, ref=None, lam: float = 4.0):
    """Divergence-adaptive weights over stacked deltas (leading axis K)."""
    if ref is None:
        ref = T.tree_map(lambda d: torch.mean(d, 0), deltas)
    div = torch.func.vmap(lambda d: cosine_divergence(d, ref))(deltas)
    return torch.exp(-lam * div)


def sparse_drag_weights(deltas, like, ref=None, lam: float = 4.0):
    """DRAG weights read straight off a stacked SparseLeaf wire.  Without a
    reference the round mean is built once by the sparse aggregate (uniform
    weights); the divergences are k-cost gathers against it."""
    if ref is None:
        K = _leading_dim(deltas)
        ones = torch.ones((K,), dtype=torch.float32,
                          device=T.leaves(like)[0].device)
        ref = sparse_weighted_mean(deltas, ones, like)
    return torch.exp(-lam * sparse_cosine_divergence(deltas, ref))


def compute_weights(name: str, deltas, n_examples=None, ref=None,
                    lam: float = 4.0, like=None):
    """Unnormalised aggregation weights (K,) fp32 for stacked deltas, dense
    or SparseLeaf wires (``like``: the dense template the sparse DRAG
    fallback aggregates into; unused otherwise)."""
    K = _leading_dim(deltas)
    device = _first_tensor(deltas).device
    if name == "uniform":
        return torch.ones((K,), dtype=torch.float32, device=device)
    if name == "examples":
        if n_examples is None:
            raise ValueError("aggregator='examples' needs per-client counts")
        return torch.as_tensor(n_examples, dtype=torch.float32, device=device)
    if name == "drag":
        if is_sparse_tree(deltas):
            if like is None:
                raise ValueError("sparse drag weights need a dense template "
                                 "(like=) for the round-mean fallback")
            return sparse_drag_weights(deltas, like, ref=ref, lam=lam)
        return drag_weights(deltas, ref=ref, lam=lam)
    raise ValueError(f"unknown aggregator {name!r}; "
                     f"known: {', '.join(KNOWN_AGGREGATORS)}")


def weighted_mean(deltas, weights):
    """Σ_i w_i·Δ_i / Σ_i w_i over a stacked tree (leading axis K).

    The reduction accumulates in fp32 whatever the delta dtype and casts on
    write: summing bf16 deltas in bf16 loses the aggregate to rounding as K
    grows."""
    wn = weights.float() / torch.clamp(torch.sum(weights), min=_EPS)
    return ops.weighted_delta_reduce_tree(deltas, wn)
