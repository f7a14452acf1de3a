"""The wire layer, uncompressed codecs only (counterpart of the JAX
package's ``federated/transport.py``; the lossy and sparse codecs and the
delta downlink come with the wire slice).

* ``none`` bypasses the codec: the tree passes untouched.
* ``identity`` goes through a codec that passes the tree untouched, so its
  trajectories equal ``none``'s bit for bit.

Both directions keep measured (wire-format) and raw byte counters; for
these codecs the two are equal.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core import tree as T
from repro_torch.telemetry import Counters

KNOWN_CODECS = ("none", "identity")


def raw_nbytes(tree) -> int:
    """Uncompressed bytes of a tree of tensors."""
    return sum(x.numel() * x.element_size() for x in T.leaves(tree))


class IdentityCodec:
    name = "identity"

    def encode(self, tree, ef, key=None):
        return tree, ef

    def decode(self, wire, like=None):
        return wire

    def roundtrip(self, tree, ef, key=None):
        wire, new_ef = self.encode(tree, ef, key)
        return self.decode(wire, tree), new_ef

    def wire_nbytes(self, template) -> int:
        return raw_nbytes(template)


def make_codec(name: str, direction: str = "uplink") -> Optional[IdentityCodec]:
    """Codec for one wire direction (None = bypass)."""
    if name == "none":
        return None
    if name == "identity":
        return IdentityCodec()
    raise NotImplementedError(f"{direction} compressor {name!r} is not "
                              f"ported yet; known: {', '.join(KNOWN_CODECS)}")


class Transport:
    """Downlink broadcast codec, uplink delta codec, and byte accounting for
    both directions.  Engines own their instance."""

    def __init__(self, fed, counters=None):
        if fed.sparse_uplink and fed.compressor not in ("topk", "none"):
            raise ValueError(
                f"sparse_uplink is the (value, index) top-k wire format; "
                f"compressor={fed.compressor!r} has no sparse path")
        self.fed = fed
        self.up = make_codec(fed.compressor, "uplink")
        self.down = make_codec(fed.downlink_compressor, "downlink")
        self.ef_enabled = False      # no lossy codec, so no EF residual
        self.counters = counters if counters is not None else Counters()
        self._up_nbytes = self._up_raw = 0
        self._down_nbytes = self._down_raw = 0

    @property
    def uplink_bytes(self):
        return self.counters.get("transport.uplink_bytes")

    @property
    def uplink_bytes_raw(self):
        return self.counters.get("transport.uplink_bytes_raw")

    @property
    def downlink_bytes(self):
        return self.counters.get("transport.downlink_bytes")

    @property
    def downlink_bytes_raw(self):
        return self.counters.get("transport.downlink_bytes_raw")

    def broadcast(self, params, ctx):
        """Downlink: (θ_t, client ctx) as the clients receive them."""
        if self.down is None:
            return params, ctx
        (params_w, ctx_w), _ = self.down.roundtrip((params, ctx), None)
        return params_w, ctx_w

    def uplink(self, delta, ef=None):
        """Uplink round trip of the (client-stacked) deltas -> (the
        reconstruction the server aggregates, new EF residual)."""
        if self.up is None:
            return delta, ef
        return self.up.roundtrip(delta, ef)

    def set_wire_templates(self, uplink_template, downlink_template=None):
        """Per-client wire sizes: uplink = the delta tree, downlink =
        (θ_t, ctx)."""
        self._up_raw = raw_nbytes(uplink_template)
        self._up_nbytes = (self._up_raw if self.up is None
                           else self.up.wire_nbytes(uplink_template))
        if downlink_template is not None:
            self._down_raw = raw_nbytes(downlink_template)
            self._down_nbytes = (self._down_raw if self.down is None
                                 else self.down.wire_nbytes(downlink_template))

    def account_uplink(self, n_clients: int = 1):
        self.counters.inc("transport.uplink_bytes",
                          n_clients * self._up_nbytes)
        self.counters.inc("transport.uplink_bytes_raw",
                          n_clients * self._up_raw)

    def account_downlink(self, n_clients: int = 1):
        self.counters.inc("transport.downlink_bytes",
                          n_clients * self._down_nbytes)
        self.counters.inc("transport.downlink_bytes_raw",
                          n_clients * self._down_raw)
