"""The federated engines and the round protocol (counterpart of the JAX
package's ``federated/``).

* ``protocol``     — ``RoundProtocol``: strategy + aggregator + transport +
                     store, composed once; every engine drives it.
* ``transport``    — ``Transport``: both wire directions with measured-byte
                     accounting.
* ``store``        — ``ClientStore``: the per-client tree store.
* ``simulator``    — the paper-scale synchronous round loop.
* ``async_engine`` — the virtual-clock semi-async engine (buffered-K,
                     staleness-discounted FedADC).
* ``hetero``       — the client system model: speeds, availability, H_i.
* ``aggregation``  — the server aggregators (uniform/examples/DRAG).
* ``compression``  — the delta compressors the transport codecs wrap.
* ``fleet``        — two-tier aggregation, the paged client store and the
                     region-aware scheduler.
"""
from repro_torch.federated.aggregation import compute_weights, weighted_mean
from repro_torch.federated.async_engine import AsyncFederatedSimulator
from repro_torch.federated.compression import (get_compressor, raw_nbytes,
                                               uplink_nbytes)
from repro_torch.federated.fleet import (FleetScheduler,
                                         HierarchicalAggregator,
                                         PagedClientStore)
from repro_torch.federated.hetero import (ClientSystemModel, fednova_scale,
                                          staleness_discount)
from repro_torch.federated.protocol import RoundProtocol
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.federated.store import ClientStore
from repro_torch.federated.transport import (SparseLeaf, Transport,
                                             downlink_nbytes)

__all__ = ["FederatedSimulator", "SimConfig", "AsyncFederatedSimulator",
           "ClientSystemModel", "fednova_scale", "staleness_discount",
           "compute_weights", "weighted_mean", "get_compressor",
           "raw_nbytes", "uplink_nbytes", "downlink_nbytes",
           "RoundProtocol", "Transport", "ClientStore", "SparseLeaf",
           "FleetScheduler", "HierarchicalAggregator", "PagedClientStore"]
