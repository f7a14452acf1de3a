"""Per-round drift diagnostics (counterpart of the JAX package's
``telemetry/drift.py``).

FedADC's claim is that local momentum *controls drift*; these are the
scalar reductions that make drift observable every round:

* ``delta_dispersion`` — client-delta divergence
  ``mean_i ||Δ_i − Δ̄||² / ||Δ̄||²`` (DRAG's divergence signal, arXiv
  2309.01779, computed as a diagnostic rather than a weighting);
* ``momentum_alignment`` — ``cos(m̄, Δ̄)`` between the server momentum and
  the round aggregate;
* ``ef_residual_norm`` — mean per-client ``||e_i||`` of the uplink
  error-feedback residuals;
* ``update_norm`` — ``||Δ̄||``.

Each returns a 0-d fp32 tensor on the trees' device, and the engines fetch
a round's scalars to the host in one transfer.  The key set of
``round_metrics`` depends only on whether a momentum and EF residuals are
given, never on values.

The trees are the port's dicts, client-stacked on a leading axis K where
the reference vmaps over clients.  A dense tree is reduced as one buffer:
its leaves are concatenated into one (K, P) (or (P,)) tensor, so a round's
metrics are a few dozen ATen calls and about fifteen kernel launches
whatever the number of leaves; a stacked SparseLeaf wire (the sparse-native
aggregate's input) is read off the wire, never densified.  Sums run in
fp32, in another order than the reference's per-leaf ``vdot``: the two
agree to fp32 rounding.

``streaming_sq_norm`` / ``streaming_dispersion`` are the client-serial
form (the pod engine's scan accumulates ``Σ w_i·||Δ_i||²``, one scalar,
and the weighted dispersion follows from ``E_w||Δ − Δ̄||² = E_w||Δ||² −
||Δ̄||²``), so no stacked delta tree is ever built.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as T

EPS = 1e-12


def _is_sparse_stack(deltas) -> bool:
    # lazy: the federated package imports telemetry
    from repro_torch.federated.compression import is_sparse_tree
    return is_sparse_tree(deltas)


def _flat(tree, stacked: bool = False):
    """A tree's leaves as one buffer: (K, P) client rows when ``stacked``,
    else (P,)."""
    leaves = T.leaves(tree)
    if stacked:
        k = leaves[0].shape[0]
        return torch.cat([x.reshape(k, -1) for x in leaves], 1)
    return torch.cat([x.reshape(-1) for x in leaves])


def _sq(x):
    """Σ x² over the last axis, in fp32."""
    x = x.float()
    return torch.sum(x * x, -1)


def _dispersion(deltas, md, nbar, mean_delta):
    if _is_sparse_stack(deltas):
        return sparse_delta_dispersion(deltas, mean_delta, nbar=nbar)
    # the difference in the leaves' dtype, its square in fp32, as the
    # reference's sq_norm(sub(d, mean_delta))
    per = _sq(_flat(deltas, stacked=True) - md)
    return torch.mean(per) / (nbar + EPS)


def _alignment(mom, md, nbar):
    num = torch.dot(mom.float(), md.float())
    return num / torch.sqrt(_sq(mom) * nbar + EPS)


def delta_dispersion(deltas, mean_delta):
    """``mean_i ||Δ_i − Δ̄||² / ||Δ̄||²`` over a client-stacked delta tree:
    dense tensors or SparseLeaf wires."""
    md = _flat(mean_delta)
    return _dispersion(deltas, md, _sq(md), mean_delta)


def sparse_delta_dispersion(wire, mean_delta, nbar=None):
    """Dispersion from the stacked SparseLeaf wire without densifying any
    client: ``||Δ_i − Δ̄||² = ||Δ_i||² − 2⟨Δ_i, Δ̄⟩ + ||Δ̄||²``, the norm
    Σv² off the wire and the dot a k-cost gather against the dense round
    aggregate.  Clamped at 0: the identity can go epsilon-negative in fp32
    where the dense form cannot."""
    from repro_torch.federated import aggregation as A
    if nbar is None:
        nbar = _sq(_flat(mean_delta))
    per = (A.sparse_sq_norms(wire)
           - 2.0 * A.sparse_dot_dense(wire, mean_delta) + nbar)
    per = torch.clamp(per, min=0.0)
    return torch.mean(per) / (nbar + EPS)


def momentum_alignment(momentum, mean_delta):
    """``cos(m̄, Δ̄)``; 0 while either side is (numerically) zero, e.g. the
    round-0 momentum."""
    md = _flat(mean_delta)
    return _alignment(_flat(momentum), md, _sq(md))


def ef_residual_norm(efs):
    """Mean per-client ``||e_i||`` over a client-stacked EF-residual tree."""
    return torch.mean(torch.sqrt(_sq(_flat(efs, stacked=True))))


def update_norm(mean_delta):
    return torch.sqrt(_sq(_flat(mean_delta)))


def round_metrics(deltas, mean_delta, momentum=None, efs=None):
    """The per-round drift dict for engines that hold the stacked deltas
    (the sync simulator's round, the async flush).  Its keys depend only on
    whether ``momentum`` and ``efs`` are given.  Δ̄ is flattened and its
    norm taken once for every metric."""
    md = _flat(mean_delta)
    nbar = _sq(md)
    m = {
        "delta_dispersion": _dispersion(deltas, md, nbar, mean_delta),
        "update_norm": torch.sqrt(nbar),
    }
    if momentum is not None:
        m["momentum_alignment"] = _alignment(_flat(momentum), md, nbar)
    if efs is not None:
        m["ef_residual_norm"] = ef_residual_norm(efs)
    return m


# ---------------------------------------------------------------------------
# streaming (client-serial) form: one scalar second moment accumulated over
# the clients instead of their stacked deltas
# ---------------------------------------------------------------------------
def streaming_sq_norm(delta, weight):
    """One client's contribution to ``Σ w_i·||Δ_i||²`` (fp32); read straight
    off a SparseLeaf wire when the uplink is sparse-native."""
    if _is_sparse_stack(delta):
        from repro_torch.federated import aggregation as A
        return weight * A.sparse_sq_norms(delta)
    return weight * _sq(_flat(delta))


def streaming_dispersion(sum_w_sq_norm, weight_sum, mean_delta):
    """Weighted dispersion ``E_w||Δ_i − Δ̄||² / ||Δ̄||²`` from the
    accumulated moments: ``E_w||Δ||² − ||Δ̄||²`` over ``||Δ̄||²``.  Equals
    :func:`delta_dispersion` under uniform weights, to fp32 rounding."""
    nbar = _sq(_flat(mean_delta))
    second = sum_w_sq_norm / (weight_sum + EPS)
    return torch.clamp(second - nbar, min=0.0) / (nbar + EPS)
