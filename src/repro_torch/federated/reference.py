"""The downlink reference layer (counterpart of the JAX package's
``federated/reference.py``).

``ReferenceStore`` owns one fact behind one interface: what tree the
clients currently hold.

* **global multicast reference** — ``broadcast(version, compute)`` memoises
  one wire reconstruction per server version and advances the codec
  reference exactly once per version.  The reference is held only for the
  lossy delta family (``Transport.stateful_downlink``): the lossless
  configuration reconstructs θ_t exactly whatever the reference, so it
  holds none.
* **per-client unicast** (``FedConfig.downlink_unicast``) — ``dispatch``
  keeps each client's last-received version and classifies every dispatch:
  *fresh* (already holds this version, 0 bytes), *catch-up* (staleness ≤
  ``FedConfig.resync_horizon``: the chained delta against their version,
  steady-state delta bytes) or *resync* (past the horizon or never seen:
  the full θ).  Accounting is per dispatched client
  (``Transport.account_unicast``), with ``downlink.catchups`` /
  ``downlink.resyncs`` counters and a per-dispatch payload histogram
  (``downlink.client_kb``).  With a client store attached, each dispatched
  client's wire lands in its ``"downlink_ref"`` page.

The per-client ledgers are dicts keyed by client id and written by item
assignment only, so a long-lived engine holds O(clients) host state; the
wire memo is one slot.  Unicast is restricted to the lossless delta family
(``Transport`` checks): every client then gets the exact θ_t from one
broadcast tree, and only the bookkeeping and the bytes are per client.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.core import tree as T
from repro_torch.telemetry import Histogram

# the store namespace per-client reference pages live in (one page per
# dispatched client: the {"params", "ctx"} wire that client last received)
REF_NAMESPACE = "downlink_ref"


class ReferenceStore:
    """All downlink reference state behind the interface every engine
    drives (engine-local, host-side bookkeeping)."""

    def __init__(self, fed, transport, store=None, telemetry=None):
        self.fed = fed
        self.transport = transport
        self.store = store
        self.unicast = bool(fed.downlink_unicast)
        self.horizon = int(fed.resync_horizon)
        # the codec reference R_v = the previous broadcast reconstruction,
        # held only for the lossy delta family
        self._ref = None
        # single-slot wire memo: one broadcast per server version
        self._wire_version: Optional[int] = None
        self._wire = None
        # per-client ledgers keyed by client id: O(clients)
        self._client_version: Dict[int, int] = {}
        self.client_bytes: Dict[int, int] = {}
        self.client_catchups: Dict[int, int] = {}
        self.client_resyncs: Dict[int, int] = {}
        self._registered = False
        self._kb_hist = (telemetry.histogram("downlink.client_kb")
                         if telemetry is not None else Histogram(n_bins=32))

    @property
    def counters(self):
        return self.transport.counters

    @property
    def catchups(self) -> int:
        return self.counters.get("downlink.catchups")

    @property
    def resyncs(self) -> int:
        return self.counters.get("downlink.resyncs")

    # --- the codec reference -------------------------------------------
    def seed(self, ref) -> None:
        """Install the round-0 reference (the initial sync), kept only when
        the downlink reconstruction depends on it."""
        self._ref = ref if self.transport.stateful_downlink else None

    def reference(self):
        """The reference the next broadcast codes against (None when the
        codec is stateless or lossless)."""
        return self._ref

    def advance(self, version: int, wire, new_ref) -> None:
        """Record version `version`'s wire in the memo and advance the
        codec reference to the new reconstruction."""
        self._wire_version = version
        self._wire = wire
        if self.transport.stateful_downlink:
            self._ref = new_ref

    # --- the broadcast memo --------------------------------------------
    def broadcast(self, version: int, compute):
        """The version-`version` broadcast, computed at most once per server
        version: ``compute(ref) -> (params_w, ctx_w, new_ref)`` runs only on
        a memo miss, and the reference advances exactly once per version.
        -> (params_w, ctx_w)."""
        if self._wire_version != version:
            params_w, ctx_w, new_ref = compute(self._ref)
            self.advance(version, (params_w, ctx_w), new_ref)
        return self._wire

    # --- dispatch accounting + per-client bookkeeping -------------------
    def dispatch(self, clients, version: int, wire=None) -> None:
        """Account one dispatch wave at server version `version`.

        Multicast: every dispatched client pays the steady-state payload,
        with version 0 charged as the delta codec's full initial sync.
        Unicast: each client is classified against their last-received
        version and charged per client, and, with a store attached and the
        wave's `wire` given, the wire is written into their page."""
        clients = [int(c) for c in clients]
        if not self.unicast:
            self.transport.account_downlink(len(clients),
                                            resync=(version == 0))
            return
        t = self.transport
        n_fresh = n_catchup = n_resync = 0
        for c in clients:
            last = self._client_version.get(c)
            if last is None or version - last > self.horizon:
                n_resync += 1
                nbytes = t._down_raw
                self.client_resyncs[c] = self.client_resyncs.get(c, 0) + 1
            elif version == last:
                n_fresh += 1
                nbytes = 0
            else:
                # the lossless dense delta costs steady-state bytes however
                # many versions it spans
                n_catchup += 1
                nbytes = t._down_nbytes
                self.client_catchups[c] = self.client_catchups.get(c, 0) + 1
            self._client_version[c] = version
            self.client_bytes[c] = self.client_bytes.get(c, 0) + nbytes
            self._kb_hist.observe(nbytes // 1024)
        t.account_unicast(n_fresh, n_catchup, n_resync)
        self.counters.inc("downlink.catchups", n_catchup)
        self.counters.inc("downlink.resyncs", n_resync)
        if wire is not None and self.store is not None:
            self._write_pages(clients, wire)

    def client_staleness(self, client, version: int) -> Optional[int]:
        """`version` minus the client's last-received version (None before
        their first dispatch)."""
        last = self._client_version.get(int(client))
        return None if last is None else version - last

    # --- per-client reference pages --------------------------------------
    def _write_pages(self, clients, wire) -> None:
        params_w, ctx_w = wire
        page = {"params": params_w, "ctx": ctx_w}
        if not self._registered:
            # the store's lazy-init contract needs a real zeros builder
            specs = T.tree_map(lambda x: (tuple(x.shape), x.dtype, x.device),
                               page)
            self.store.register(
                REF_NAMESPACE,
                lambda: T.tree_map(lambda s: torch.zeros(s[0], dtype=s[1],
                                                         device=s[2]),
                                   specs))
            self._registered = True
        view = self.store.states(REF_NAMESPACE)
        for c in clients:
            view[c] = page

    def client_reference(self, client):
        """The (params, ctx) wire one client last received, or None before
        their first dispatch."""
        if self.store is None or not self._registered:
            return None
        if int(client) not in self.store.states(REF_NAMESPACE):
            return None
        stacked = self.store.gather(REF_NAMESPACE, [int(client)])
        page = T.tree_map(lambda x: x[0], stacked)
        return page["params"], page["ctx"]
