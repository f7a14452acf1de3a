"""Per-client tree stores (counterpart of the JAX package's
``federated/store.py``): the host-backed ``ClientStore`` of the simulator
and the async engine, and the pod engine's stacked device store
(``sharded_*``).

One gather/scatter interface for per-client cross-round state, in named
namespaces: ``"state"`` (SCAFFOLD control variates ``c_i``, FedDyn drift
corrections), ``"ef"`` (the uplink's error-feedback residuals) and
``"downlink_ref"`` (the wire each client last received, under the unicast
downlink).  The simulator gathers the round's picks into one client-stacked
tree, runs the round, and scatters the updated states back.  A state is
lazily initialised on first gather; ``is None`` (not truthiness) decides
whether a slot is empty.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch

from repro_torch.core.tree import tree_map


class ClientStore:
    """Per-client tree store with named state collections."""

    def __init__(self):
        self._ns: Dict[str, Dict[int, Any]] = {}
        self._init: Dict[str, Callable[[], Any]] = {}
        self._template: Dict[str, Any] = {}

    def register(self, name: str, init_fn: Callable[[], Any]) -> None:
        """Declare a namespace; `init_fn()` builds one client's fresh state."""
        # item assignment keyed by namespace name: bounded by the few
        # namespaces an engine declares
        self._ns[name] = self._ns.get(name, {})
        self._init[name] = init_fn
        self._template.pop(name, None)

    def states(self, name: str) -> Dict[int, Any]:
        """The live dict for a namespace (mutable view, keyed by client id)."""
        return self._ns[name]

    def gather(self, name: str, picks: Sequence[int]):
        """Stack the picks' states (fresh-initialising empty slots) into one
        tree with leading axis len(picks)."""
        store, init_fn = self._ns[name], self._init[name]
        states = []
        for c in picks:
            s = store.get(int(c))
            if s is None:
                if name not in self._template:
                    self._template[name] = init_fn()
                s = self._template[name]
            states.append(s)
        return tree_map(lambda *xs: torch.stack(xs), *states)

    def scatter(self, name: str, picks: Sequence[int], stacked) -> None:
        """Write each pick's slice of the stacked tree back to its slot."""
        store = self._ns[name]
        for j, c in enumerate(picks):
            store[int(c)] = tree_map(lambda x: x[j].clone(), stacked)


# ---------------------------------------------------------------------------
# the pod engine's stacked store: every leaf carries a leading (n_clients,)
# axis on the device
# ---------------------------------------------------------------------------
def sharded_init(template, n_clients: int):
    """All-zeros store: every leaf of ``template`` gains a leading
    (n_clients,) axis, in the leaf's dtype and on its device."""
    return tree_map(lambda x: torch.zeros((n_clients,) + tuple(x.shape),
                                          dtype=x.dtype, device=x.device),
                    template)


def sharded_gather(store, ids):
    """store (N, ...) x ids (K,) int -> stacked copies (K, ...)."""
    ids = ids.long()
    return tree_map(lambda x: x.index_select(0, ids), store)


def _last_occurrence(ids):
    """For each position j of ids (K,), the last position holding ids[j],
    computed on the device (no read-back)."""
    pos = torch.arange(ids.shape[0], device=ids.device)
    same = ids[:, None] == ids[None, :]
    return torch.where(same, pos[None, :], -1).amax(1)


def sharded_scatter(store, ids, values):
    """Write rows ``ids`` of the store from ``values`` (K, ...) in place ->
    ``store`` itself, the same tensors (the reference returns a new store;
    here a caller that keeps the old tree sees the new rows in it).

    Duplicate ids resolve to the last write, as the reference's scatter
    does: every occurrence of an id writes the row of its last occurrence,
    so the order in which the device lands the writes cannot matter.  The
    write is in place, leaf by leaf: the store is the largest tensor the
    engine holds (8 bf16 copies of zamba2-1.2b are 17.7 GB), so a
    functional copy would double it."""
    ids = ids.long()
    src = _last_occurrence(ids)
    return tree_map(
        lambda x, v: x.index_copy_(0, ids, v.index_select(0, src).to(x.dtype)),
        store, values)
