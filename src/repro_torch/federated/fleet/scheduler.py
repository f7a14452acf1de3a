"""Region-aware cohort sampling (counterpart of the JAX package's
``federated/fleet/scheduler.py``; numpy, like it, and its picks are the
reference's bit for bit under the same seed).

``core/selection.py`` draws a flat pick from the whole fleet; a
hierarchical topology needs the round's cohort shaped to its regions and
weighted by the fleet's system model.  ``FleetScheduler``:

* assigns the N clients to R contiguous regions with the same
  ``region_sizes`` split the ``HierarchicalAggregator`` slices by, and
  emits its picks region-major, so the k-th delta of a cohort lands in the
  aggregator region that owns client k;
* samples each region's sub-cohort with availability/speed weights from
  the ``hetero`` system model, or delegates to ``selection.py``'s
  ``class_coverage`` selector on the region's sub-population;
* draws from one private ``RandomState`` in call order, independent of the
  engines' streams;
* feeds the engines: ``sample_cohort()`` gives the sync round its picks,
  ``sample(n)`` the async engine its region-agnostic dispatch waves.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.selection import class_coverage_selection
from repro_torch.federated.fleet.hierarchy import (region_sizes,
                                                   region_slices, slices_of)
from repro_torch.federated.hetero import sample_speeds

KNOWN_SELECTORS = ("random", "class_coverage")


@dataclass(frozen=True)
class Cohort:
    """One round's picks in region-major order: ``clients[offset_r :
    offset_r + sizes[r]]`` is region r's sub-cohort."""
    clients: np.ndarray
    sizes: Tuple[int, ...]

    def region_slices(self) -> Tuple[Tuple[int, int], ...]:
        return slices_of(self.sizes)

    def pod_client_ids(self, cp: int, cs: int) -> np.ndarray:
        """The cohort as the pod engine's (CP, CS) int32 client-id grid
        (client-serial within a pod, pod after pod)."""
        if cp * cs != len(self.clients):
            raise ValueError(f"cohort of {len(self.clients)} clients does "
                             f"not fill a ({cp}, {cs}) pod grid")
        return np.asarray(self.clients, np.int32).reshape(cp, cs)


class FleetScheduler:
    """Deterministic region-aware cohort sampler over the fleet."""

    def __init__(self, fed, hetero=None, *, n_regions: Optional[int] = None,
                 selector: str = "random", counts=None, seed: int = 0):
        if selector not in KNOWN_SELECTORS:
            raise ValueError(f"unknown selector {selector!r}; "
                             f"known: {', '.join(KNOWN_SELECTORS)}")
        if selector == "class_coverage" and counts is None:
            raise ValueError("selector='class_coverage' needs per-client "
                             "class counts (counts=)")
        self.fed = fed
        self.n_clients = fed.n_clients
        regions = n_regions if n_regions is not None \
            else max(fed.fleet_regions, 1)
        if not 1 <= regions <= self.n_clients:
            raise ValueError(f"n_regions={regions} outside "
                             f"[1, {self.n_clients}]")
        self.n_regions = regions
        self.selector = selector
        self.counts = None if counts is None else np.asarray(counts)
        self.rng = np.random.RandomState(seed)
        # contiguous region blocks — the aggregator's exact split
        self.bounds = region_slices(self.n_clients, regions)
        self._starts = [start for start, _ in self.bounds]
        # availability/speed sampling weights, the speeds drawn from
        # hetero's own seed as the engines' ClientSystemModel draws them
        if hetero is not None:
            speeds = sample_speeds(hetero, self.n_clients,
                                   np.random.RandomState(hetero.seed))
        else:
            speeds = np.ones(self.n_clients, np.float64)
        self.speeds = speeds
        self.availability = float(hetero.availability) \
            if hetero is not None and hetero.enabled else 1.0

    # ------------------------------------------------------------------
    def region_of(self, client: int) -> int:
        return bisect.bisect_right(self._starts, int(client)) - 1

    def region_clients(self, r: int) -> np.ndarray:
        start, size = self.bounds[r]
        return np.arange(start, start + size)

    def sample_cohort(self, k: Optional[int] = None) -> Cohort:
        """One region-major cohort of k clients (default
        ``fed.clients_per_round``), split over regions by the shared
        ``region_sizes`` rule."""
        k = self.fed.clients_per_round if k is None else int(k)
        sizes = region_sizes(k, self.n_regions)
        picks = [self._sample_region(r, k_r) for r, k_r in enumerate(sizes)]
        return Cohort(np.concatenate(picks), sizes)

    def sample(self, n: int) -> np.ndarray:
        """Region-agnostic weighted draw of n clients — the async engine's
        dispatch waves (a redispatch of 1 has no meaningful region split)."""
        return self._weighted_pick(np.arange(self.n_clients), n)

    # ------------------------------------------------------------------
    def _sample_region(self, r: int, k_r: int) -> np.ndarray:
        clients = self.region_clients(r)
        if k_r > len(clients):
            raise ValueError(f"region {r} holds {len(clients)} clients; "
                             f"cannot sample {k_r}")
        if self.selector == "class_coverage":
            local = class_coverage_selection(self.rng, len(clients), k_r,
                                             self.counts[clients])
            return clients[np.asarray(local)]
        return self._weighted_pick(clients, k_r)

    def _weighted_pick(self, clients: np.ndarray, k: int) -> np.ndarray:
        """k clients without replacement, ∝ speed over this round's
        available subset (availability thinning is skipped when it would
        leave fewer than k candidates — a dispatch never under-fills)."""
        w = np.asarray(self.speeds[clients], np.float64).copy()
        if self.availability < 1.0:
            up = self.rng.rand(len(clients)) < self.availability
            if int(up.sum()) >= k:
                w = np.where(up, w, 0.0)
        return self.rng.choice(clients, size=k, replace=False, p=w / w.sum())
