"""The unified round protocol: strategy + aggregator + transport + store
(counterpart of the JAX package's ``federated/protocol.py:40-167``, without
its hierarchical and sparse branches).

Every engine runs the same abstract round:

    1. broadcast   — θ_t and the strategy's client context go down the wire
    2. local work  — clients run H local steps (engine-specific execution)
    3. uplink      — each delta rides the uplink codec
    4. aggregate   — pluggable weights + ``strategy.server_aggregate``
    5. server step — the strategy's momentum/update recursion

The constructor also rejects every configuration this slice of the port
does not support, with ``NotImplementedError``, so no run silently takes a
path that differs from the reference.
"""
from __future__ import annotations

from typing import Callable, Optional

from repro_torch.core.strategies import get_strategy
from repro_torch.federated import aggregation as A
from repro_torch.federated.reference import ReferenceStore
from repro_torch.federated.store import ClientStore
from repro_torch.federated.transport import Transport

# strategies whose server corrections are rebuilt from auxiliary uplink
# state (SCAFFOLD c_i deltas, FedDyn raw drift sums): their corrections are
# *uniform* means, so non-uniform weights would bias them
STATEFUL_SERVER_CORRECTION = ("scaffold", "feddyn")

# strategies whose local loss is not the plain cross-entropy
LOSS_MODIFIERS = ("moon", "fedgkd", "fedntd", "fedrs")


def check_supported(fed) -> None:
    """Raise NotImplementedError for a config outside this slice."""
    unsupported = []
    if fed.strategy in LOSS_MODIFIERS:
        unsupported.append(f"strategy={fed.strategy!r} (its local loss)")
    if fed.distill:
        unsupported.append("distill=True (FedADC+ self-confidence KD)")
    if fed.compressor not in ("none", "identity"):
        unsupported.append(f"compressor={fed.compressor!r}")
    if fed.downlink_compressor not in ("none", "identity"):
        unsupported.append(f"downlink_compressor={fed.downlink_compressor!r}")
    if fed.downlink_unicast:
        unsupported.append("downlink_unicast=True")
    if fed.fleet_regions > 0:
        unsupported.append(f"fleet_regions={fed.fleet_regions}")
    if unsupported:
        raise NotImplementedError("not ported yet: " + ", ".join(unsupported))


class RoundProtocol:
    """One federated round's pluggable pieces, composed once per engine."""

    def __init__(self, fed, strategy=None, store: Optional[ClientStore] = None,
                 transport: Optional[Transport] = None, telemetry=None):
        check_supported(fed)
        self.fed = fed
        self.strategy = strategy if strategy is not None \
            else get_strategy(fed.strategy)
        if transport is not None:
            self.transport = transport
        else:
            counters = telemetry.counters if telemetry is not None else None
            self.transport = Transport(fed, counters=counters)
        self.store = store if store is not None else ClientStore()
        self.refs = ReferenceStore(fed, self.transport)
        if fed.strategy in STATEFUL_SERVER_CORRECTION \
                and fed.aggregator != "uniform":
            raise ValueError(
                f"aggregator={fed.aggregator!r} is not supported with "
                f"{fed.strategy!r}; use aggregator='uniform'")
        self.ef_enabled = self.transport.ef_enabled

    # --- store wiring ---------------------------------------------------
    def register_client_state(self, init_fn: Callable) -> None:
        self.store.register("state", init_fn)

    def register_ef(self, init_fn: Callable) -> None:
        self.store.register("ef", init_fn)

    # --- round steps ----------------------------------------------------
    def client_ctx(self, server_state, params):
        """Step 1: build the strategy's client context and push (θ_t, ctx)
        through the downlink codec -> (params', ctx') as received."""
        ctx = self.strategy.client_setup(server_state, params, self.fed)
        return self.transport.broadcast(params, ctx)

    def uplink(self, deltas, efs=None):
        """Step 3: the clients' wire round trip (client-stacked trees)."""
        return self.transport.uplink(deltas, efs)

    def weights(self, deltas, n_examples=None, server_state=None):
        """Step 4a: aggregation weights from the pluggable aggregator; the
        DRAG reference is the server momentum when the strategy keeps one."""
        ref = A.reference_direction(server_state)
        return A.compute_weights(self.fed.aggregator, deltas,
                                 n_examples=n_examples, ref=ref,
                                 lam=self.fed.drag_lambda)

    def aggregate(self, deltas, weights):
        """Step 4b: Δ̄ through the strategy's shared reduction."""
        return self.strategy.server_aggregate(deltas, weights, self.fed)

    def server_update(self, server_state, params, mean_delta):
        """Step 5 (common path; SCAFFOLD/FedDyn keep their dedicated server
        hooks in the simulator)."""
        return self.strategy.server_update(server_state, params, mean_delta,
                                           self.fed)
