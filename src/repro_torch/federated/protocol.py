"""The unified round protocol: strategy + aggregator + transport + store
(counterpart of the JAX package's ``federated/protocol.py``).

Every engine runs the same abstract round:

    1. broadcast   — θ_t and the strategy's client context go down the wire
    2. local work  — clients run H local steps (engine-specific execution:
                     client-stacked in the simulator, dispatch groups of
                     one H_i each in the async engine)
    3. uplink      — each delta rides the uplink codec against the client's
                     error-feedback residual from the ``ClientStore``
    4. aggregate   — pluggable weights + ``strategy.server_aggregate``, or
                     the sparse-native aggregate of a SparseLeaf wire; with
                     ``fleet_regions > 0`` both run per region and the R
                     partials combine in fp32 (``fleet.hierarchy``)
    5. server step — the strategy's momentum/update recursion
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.strategies import get_strategy
from repro_torch.federated import aggregation as A
from repro_torch.federated.reference import ReferenceStore
from repro_torch.federated.store import ClientStore
from repro_torch.federated.transport import Transport

# strategies whose server corrections are rebuilt from auxiliary uplink
# state (SCAFFOLD c_i deltas, FedDyn raw drift sums) the wire codecs do not
# model: a lossy wire would break those invariants, and their corrections
# are *uniform* means, so non-uniform weights would bias them
STATEFUL_SERVER_CORRECTION = ("scaffold", "feddyn")


class RoundProtocol:
    """One federated round's pluggable pieces, composed once per engine."""

    def __init__(self, fed, strategy=None, store: Optional[ClientStore] = None,
                 transport: Optional[Transport] = None, telemetry=None):
        self.fed = fed
        self.strategy = strategy if strategy is not None \
            else get_strategy(fed.strategy)
        if transport is not None:
            self.transport = transport
        else:
            counters = telemetry.counters if telemetry is not None else None
            self.transport = Transport(fed, counters=counters)
        self.store = store if store is not None else ClientStore()
        # the downlink reference layer: the broadcast reference, the
        # one-wire-per-version memo and the per-client unicast ledgers;
        # per-client reference pages ride this protocol's client store
        self.refs = ReferenceStore(fed, self.transport, store=self.store,
                                   telemetry=telemetry)
        # the two-tier fleet topology: aggregate() routes through the
        # regional/global reduce (lazy import: the fleet composes on top of
        # this module)
        self.hierarchical = None
        if fed.fleet_regions > 0:
            from repro_torch.federated.fleet import HierarchicalAggregator
            self.hierarchical = HierarchicalAggregator(fed, self.strategy)
        if fed.strategy in STATEFUL_SERVER_CORRECTION:
            if fed.aggregator != "uniform":
                raise ValueError(
                    f"aggregator={fed.aggregator!r} is not supported with "
                    f"{fed.strategy!r}; use aggregator='uniform'")
            if self.transport.up is not None and self.transport.up.lossy:
                raise ValueError(
                    f"compressor={fed.compressor!r} is not supported with "
                    f"{fed.strategy!r}; use compressor='none'")
            if self.transport.down is not None and self.transport.down.lossy:
                raise ValueError(
                    f"downlink_compressor={fed.downlink_compressor!r} is not "
                    f"supported with {fed.strategy!r}: the broadcast carries "
                    f"its server correction")
        self.ef_enabled = self.transport.ef_enabled

    # --- store wiring ---------------------------------------------------
    def register_client_state(self, init_fn: Callable) -> None:
        self.store.register("state", init_fn)

    def register_ef(self, init_fn: Callable) -> None:
        self.store.register("ef", init_fn)

    def init_downlink_ref(self, server_state, params):
        """The delta downlink's round-0 reference: the initial sync
        (θ_0, ctx_0) every client starts from, so the first wire delta is
        exactly zero.  None for stateless codecs."""
        if not self.transport.needs_downlink_ref:
            return None
        ctx = self.strategy.client_setup(server_state, params, self.fed)
        return self.transport.init_downlink_ref(params, ctx)

    # --- round steps ----------------------------------------------------
    def client_ctx(self, server_state, params, key=None, ref=None):
        """Step 1: build the strategy's client context and push (θ_t, ctx)
        through the downlink codec -> (params', ctx', new_ref) as received;
        ``ref``/``new_ref`` carry the delta codec's broadcast reference (None
        for stateless codecs), ``key`` the round's downlink draws."""
        ctx = self.strategy.client_setup(server_state, params, self.fed)
        return self.transport.broadcast(params, ctx, key, ref)

    def uplink(self, deltas, efs, key=None):
        """Step 3: the clients' wire round trip (client-stacked trees)."""
        return self.transport.uplink(deltas, efs, key)

    def uplink_encode(self, deltas, efs, key=None):
        """Step 3, sparse-native form: encode only, so the SparseLeaf wire
        flows straight into the sparse aggregate.  The EF residual is the
        same exact complement ``uplink`` returns."""
        return self.transport.uplink_encode(deltas, efs, key)

    def uplink_decode(self, wire, like):
        return self.transport.uplink_decode(wire, like)

    @property
    def sparse_native(self) -> bool:
        """True when the engine should keep the uplink wire sparse into the
        aggregate (``Transport.sparse_native``)."""
        return self.transport.sparse_native

    def weights(self, deltas, n_examples=None, server_state=None, like=None):
        """Step 4a: aggregation weights from the pluggable aggregator; the
        DRAG reference is the server momentum when the strategy keeps one.
        ``like`` is the dense template a sparse-wire DRAG aggregates its
        round-mean fallback into (ignored for dense deltas)."""
        ref = A.reference_direction(server_state)
        return A.compute_weights(self.fed.aggregator, deltas,
                                 n_examples=n_examples, ref=ref,
                                 lam=self.fed.drag_lambda, like=like)

    def aggregate(self, deltas, weights, like=None):
        """Step 4b: Δ̄ through the strategy's shared reduction, or, for a
        stacked SparseLeaf wire, the sparse-native aggregate at K·k cost
        (``like`` gives the dense output template).  With fleet regions
        both reduces run per region and the partials combine in fp32, bit
        for bit the flat aggregate at one region."""
        if self.hierarchical is not None:
            return self.hierarchical(deltas, weights, like=like)
        if A.is_sparse_tree(deltas):
            if like is None:
                raise ValueError("sparse-native aggregation needs a dense "
                                 "template (like=)")
            return A.sparse_weighted_mean(deltas, weights, like)
        return self.strategy.server_aggregate(deltas, weights, self.fed)

    def server_update(self, server_state, params, mean_delta):
        """Step 5 (common path; SCAFFOLD/FedDyn keep their dedicated server
        hooks in the simulator)."""
        return self.strategy.server_update(server_state, params, mean_delta,
                                           self.fed)
