"""The downlink reference layer, multicast bookkeeping only (counterpart of
the JAX package's ``federated/reference.py``).

In the multicast model every dispatched client receives the one broadcast
of the current server version, and ``dispatch`` accounts it.  The delta
downlink's reference, its one-wire-per-version memo and the per-client
unicast ledgers come with the wire slice; ``RoundProtocol`` rejects the
configurations that need them.
"""
from __future__ import annotations


class ReferenceStore:
    """Downlink bookkeeping behind the interface every engine drives."""

    def __init__(self, fed, transport):
        self.fed = fed
        self.transport = transport

    def dispatch(self, clients, version: int) -> None:
        """Account one dispatch wave at server version `version`: every
        dispatched client pays one broadcast."""
        self.transport.account_downlink(len(clients))
