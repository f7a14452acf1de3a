"""The fleet substrate (counterpart of the JAX package's
``federated/fleet/``): two-tier aggregation, a memory-bounded paged client
store and region-aware cohort scheduling.

* ``hierarchy``   — ``HierarchicalAggregator`` and ``region_sizes``: the
                    regional/global reduce ``RoundProtocol`` routes
                    through when ``fed.fleet_regions > 0`` (bit for bit the
                    flat aggregate at R = 1);
* ``paged_store`` — ``PagedClientStore``: an LRU page table of device
                    tensors under a hard resident-bytes budget, with a
                    zlib-compressed host spill tier, duck-typing
                    ``ClientStore``;
* ``scheduler``   — ``FleetScheduler``: deterministic region-major cohort
                    sampling with availability/speed weights.

The pod engine's ``hierarchical_combine`` comes with the pod engine.
"""
from repro_torch.federated.fleet.hierarchy import (HierarchicalAggregator,
                                                   hierarchical_aggregate,
                                                   region_sizes,
                                                   region_slices)
from repro_torch.federated.fleet.paged_store import (PagedClientStore,
                                                     page_nbytes)
from repro_torch.federated.fleet.scheduler import Cohort, FleetScheduler

__all__ = ["HierarchicalAggregator", "hierarchical_aggregate",
           "region_sizes", "region_slices", "PagedClientStore",
           "page_nbytes", "Cohort", "FleetScheduler"]
