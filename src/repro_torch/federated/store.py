"""Host-backed per-client tree store (counterpart of the JAX package's
``federated/store.py:37-95``).

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
