"""Two-tier hierarchical aggregation (counterpart of the JAX package's
``federated/fleet/hierarchy.py``).

A fleet does not ship every client delta to one server: edge deltas reduce
at a regional aggregator and only the R regional partials travel to the
global tier.  This maps that topology onto the port's one weighted
reduction:

* **stage 1 (regional)** — the round's K deltas chunk into R contiguous
  regional cohorts (``region_slices``; the ``FleetScheduler`` emits its
  picks region-major against the same split).  Each region runs the flat
  reduce over its slice: ``strategy.server_aggregate`` for dense deltas
  (the weighted-reduce kernel, one launch per 64 leaves) and
  ``sparse_weighted_mean`` for a SparseLeaf wire (one sparse-reduce call),
  so sparse regional partials cost K·k and only the R partials are dense;
* **stage 2 (global)** — ``weighted_mean`` over the stacked (R, ...)
  partials with weights W_r = Σ_{i∈r} w_i: fp32 accumulation, cast to the
  delta dtype on write.  By linearity this is the flat Σ_i w_i·Δ_i / Σ_i
  w_i, exactly in real arithmetic and to reassociation in floats.

At R = 1 stage 1 is the flat call on the whole round and stage 2 scales
the one partial by W/W = 1.0, so the two tiers equal the flat aggregate
bit for bit.  The pod engine's ``hierarchical_combine`` takes its CP pod
partials through the same two tiers.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import tree as T
from repro_torch.federated import aggregation as A
from repro_torch.federated.compression import SparseLeaf, is_sparse_leaf


def region_sizes(total: int, n_regions: int) -> Tuple[int, ...]:
    """Contiguous chunk sizes for ``total`` items over ``n_regions``
    regions: the first ``total % n_regions`` regions take the ceiling.
    Shared by the scheduler (cohort sizes) and the aggregator (slice
    bounds), so the two cannot disagree about which delta is whose."""
    if n_regions < 1:
        raise ValueError(f"n_regions must be >= 1, got {n_regions}")
    if total < n_regions:
        raise ValueError(f"{total} items cannot fill {n_regions} regions "
                         f"(every region needs at least one)")
    base, rem = divmod(total, n_regions)
    return tuple(base + 1 if r < rem else base for r in range(n_regions))


def slices_of(sizes) -> Tuple[Tuple[int, int], ...]:
    """((start, size), ...) of contiguous chunks of the given sizes."""
    out, start = [], 0
    for size in sizes:
        out.append((start, size))
        start += size
    return tuple(out)


def region_slices(total: int, n_regions: int) -> Tuple[Tuple[int, int], ...]:
    """((start, size), ...) slice bounds matching ``region_sizes``."""
    return slices_of(region_sizes(total, n_regions))


def _rows(x, start, size):
    """Rows [start, start + size) of a stacked leaf or SparseLeaf wire (a
    leading-axis view, contiguous like its base)."""
    if is_sparse_leaf(x):
        return SparseLeaf(x.values[start:start + size],
                          x.indices[start:start + size])
    return x[start:start + size]


def hierarchical_aggregate(deltas, weights, fed, strategy, like=None):
    """Δ̄ through the two tiers.  ``deltas`` is the stacked (K, ...) tree,
    dense or SparseLeaf wire, and ``weights`` the (K,) aggregation
    weights; ``like`` is the dense template a sparse wire needs."""
    sparse = A.is_sparse_tree(deltas)
    if sparse and like is None:
        raise ValueError("sparse-native hierarchical aggregation needs a "
                         "dense template (like=)")
    partials, region_w = [], []
    for start, size in region_slices(weights.shape[0], fed.fleet_regions):
        d_r = T.tree_map(lambda x: _rows(x, start, size), deltas)
        w_r = weights[start:start + size]
        if sparse:
            m_r = A.sparse_weighted_mean(d_r, w_r, like)
        else:
            m_r = strategy.server_aggregate(d_r, w_r, fed)
        partials.append(m_r)
        region_w.append(torch.sum(w_r))
    stacked = T.tree_map(lambda *xs: torch.stack(xs), *partials)
    return A.weighted_mean(stacked, torch.stack(region_w))


def hierarchical_combine(partials, weights, fed, strategy):
    """Pod-engine form: the per-pod partial means arriving at the final
    combine are stage-1 units already (each pod's client-serial loop is a
    regional reduce); the CP pod axis chunks into ``fed.fleet_regions``
    regions and recombines, exact by the linearity the flat pod
    recombination relies on, bit for bit at R = 1."""
    return hierarchical_aggregate(partials, weights, fed, strategy)


class HierarchicalAggregator:
    """The two-tier reduce bound to one (fed, strategy) pair: what
    ``RoundProtocol.aggregate`` routes through when
    ``fed.fleet_regions > 0``."""

    def __init__(self, fed, strategy):
        if fed.fleet_regions < 1:
            raise ValueError("HierarchicalAggregator needs fleet_regions "
                             f">= 1, got {fed.fleet_regions}")
        # every flush must fill every region (buffer_k is the async
        # engine's round size; 0 falls back to clients_per_round)
        round_k = fed.buffer_k if fed.buffer_k > 0 else fed.clients_per_round
        if fed.fleet_regions > round_k:
            raise ValueError(
                f"fleet_regions={fed.fleet_regions} exceeds the round's "
                f"{round_k} deltas; every region needs at least one client")
        self.fed = fed
        self.strategy = strategy
        self.n_regions = fed.fleet_regions

    def __call__(self, deltas, weights, like=None):
        return hierarchical_aggregate(deltas, weights, self.fed,
                                      self.strategy, like=like)
