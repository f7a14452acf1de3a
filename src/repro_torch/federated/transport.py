"""The wire layer of the federated round, both directions (counterpart of
the JAX package's ``federated/transport.py``).

* **downlink** — ``broadcast(params, ctx, key, ref)``: the server codes the
  round's broadcast (θ_t and the strategy's client context, e.g. FedADC's
  m̄_t) once, and clients train on the wire reconstruction.  The plain
  codecs (``none``/``identity``/``topk``/``qsgd``) are stateless; the
  **delta family** (``delta`` ≡ ``delta+identity``, ``delta+topk``,
  ``delta+qsgd``) codes the change against the last broadcast
  reconstruction, and strategies whose ctx is an exact scalar image of the
  θ-delta (``ctx_from_broadcast_delta``, the FedADC family) send their ctx
  at 0 bytes.
* **uplink** — ``uplink(delta, ef, key)``: the clients' deltas are encoded
  against their error-feedback memory and decoded; the server aggregates
  only wire reconstructions.  With ``FedConfig.sparse_uplink`` the wire is
  (value, index) pairs (``SparseLeaf``), which the server may aggregate
  without decoding (``sparse_native``).
* **accounting** — measured (wire-format) and raw byte counters for both
  directions.

The uplink methods take client-stacked trees (every leaf carries the
round's K clients on a leading axis).  The downlink codes one tree: the
broadcast is given a leading axis of 1 for the codec and loses it after.
``key`` is the call's ``UniformDraws`` (``compression.py``), which the
lossy codecs draw from; lossless codecs ignore it.

``shim_transport`` backs the deprecated ``strategy.compress_delta``.
"""
from __future__ import annotations

import functools
from typing import Optional

from repro_torch.core import tree as T
from repro_torch.federated import compression as C
# the wire format lives with the compressor arithmetic so the aggregation
# layer can consume it codec-free
from repro_torch.federated.compression import SparseLeaf
from repro_torch.kernels import ops
from repro_torch.telemetry import Counters


# ---------------------------------------------------------------------------
# codecs — one direction of the wire each
# ---------------------------------------------------------------------------
class Codec:
    name = "base"
    lossy = True

    def encode(self, tree, ef, key):
        """(tree, EF tree, draws) -> (wire, new EF = exact residual)."""
        raise NotImplementedError

    def decode(self, wire, like):
        """Wire -> dense tree shaped like `like` (the server's view)."""
        raise NotImplementedError

    def roundtrip(self, tree, ef, key):
        """encode then decode: -> (dense reconstruction, new EF)."""
        wire, new_ef = self.encode(tree, ef, key)
        return self.decode(wire, tree), new_ef

    def wire_nbytes(self, template) -> int:
        raise NotImplementedError


class IdentityCodec(Codec):
    name = "identity"
    lossy = False

    def encode(self, tree, ef, key):
        # pure passthrough: runs equal the bypass bit for bit
        return tree, ef

    def decode(self, wire, like):
        return wire

    def wire_nbytes(self, template) -> int:
        return C.raw_nbytes(template)


class DenseCodec(Codec):
    """A lossy compressor whose in-program wire is the dense reconstruction
    (the real bytes live only in the accounting): topk or qsgd."""

    def __init__(self, comp: C.Compressor):
        self._comp = comp
        self.name = comp.name
        self.lossy = comp.lossy

    def encode(self, tree, ef, key):
        return self._comp.compress(tree, ef, key)

    def decode(self, wire, like):
        return wire

    def wire_nbytes(self, template) -> int:
        return self._comp.wire_nbytes(template)


class SparseTopKCodec(Codec):
    """Top-k whose in-program wire IS the (value, index) format: per leaf
    and client, ``torch.topk`` picks the k = ⌈frac·n⌉ largest-|v| entries of
    v = Δ + e, the residual zeroes exactly those indices, and the server
    scatters the pairs into a dense zero leaf.  Reconstruction and residual
    equal the dense threshold path's away from magnitude ties."""
    name = "topk"
    lossy = True

    def __init__(self, frac: float):
        self._acct = C.TopKCompressor(frac)     # validation + accounting
        self.frac = frac

    def encode(self, tree, ef, key):
        def leaf(x):
            k = self._acct._k(x[0].numel())
            values, indices, residual = ops.topk_sparse_leaf(x, k)
            return SparseLeaf(values, indices), residual
        return T.unzip2(T.tree_map(leaf, T.add(tree, ef)))

    def decode(self, wire, like):
        return T.tree_map(
            lambda w, l: ops.sparse_scatter_leaf(w.values, w.indices,
                                                 l.shape[1:], l.dtype),
            wire, like)

    def wire_nbytes(self, template) -> int:
        return self._acct.wire_nbytes(template)


def _batched(tree):
    return T.tree_map(lambda x: x.unsqueeze(0), tree)


def _unbatched(tree):
    return T.tree_map(lambda x: x[0], tree)


def _roundtrip_one(codec: Codec, tree, key):
    """One (unstacked) tree through a codec with a zero EF -> its
    reconstruction."""
    batched = _batched(tree)
    rec, _ = codec.roundtrip(batched, T.zeros_like(batched), key)
    return _unbatched(rec)


class DeltaDownlinkCodec(Codec):
    """Reference-coded (momentum-aware) broadcast codec.

    The server keeps ``ref`` = the previous broadcast reconstruction
    (θ_{t−1}, ctx_{t−1}), what every up-to-date client holds, and sends the
    change:

    * lossless inner codec (``delta`` ≡ ``delta+identity``): the change is
      sent exactly, so the reconstruction IS the current tree; the tree
      passes untouched and the accounting charges the delta's raw bytes;
    * lossy inner codec (``delta+topk`` / ``delta+qsgd``): the wire is
      q(θ_t − ref_θ); clients hold ref_θ + q, which becomes the new
      reference, so coding error enters once and corrects itself.

    With ``ctx_derive`` (strategies with ``ctx_from_broadcast_delta``) the
    ctx is never sent: clients derive it from the decoded θ-delta, at 0
    bytes.  The codec holds no tensors; ``ref`` is passed in and the new
    one returned (``ReferenceStore`` keeps it).
    """
    lossy = True          # overwritten from the inner codec

    def __init__(self, inner: Codec, ctx_derive=None, name: str = "delta"):
        self.inner = inner
        self.ctx_derive = ctx_derive
        self.lossy = inner.lossy
        self.name = name

    def init_ref(self, params, ctx):
        """The reference clients hold before round 0: the initial sync."""
        return (params, ctx)

    def broadcast(self, params, ctx, ref, key):
        """-> (params_w, ctx_w, new_ref)."""
        if not self.lossy:
            # exact residual transport: reconstruction == the current tree
            return params, ctx, (params, ctx)
        ref_p, ref_c = ref
        q_p = _roundtrip_one(self.inner, T.sub(params, ref_p), key.fold(0))
        params_w = T.add(ref_p, q_p)
        if self.ctx_derive is not None:
            ctx_w = self.ctx_derive(q_p)
        else:
            q_c = _roundtrip_one(self.inner, T.sub(ctx, ref_c), key.fold(1))
            ctx_w = T.add(ref_c, q_c)
        return params_w, ctx_w, (params_w, ctx_w)

    def wire_nbytes(self, template) -> int:
        """Steady-state per-client bytes: the delta tree through the inner
        codec, a derivable ctx at 0.  The round-0 resync is accounted
        separately.  ``template`` is {"params": θ, "ctx": ctx}."""
        p_t, c_t = template["params"], template["ctx"]
        nbytes = self.inner.wire_nbytes(p_t)
        if self.ctx_derive is None:
            nbytes += self.inner.wire_nbytes(c_t)
        return nbytes


KNOWN_DOWNLINK = ("none", "identity", "topk", "qsgd", "delta",
                  "delta+identity", "delta+topk", "delta+qsgd")


def make_codec(name: str, fed, direction: str = "uplink") -> Optional[Codec]:
    """Codec for one wire direction (None = bypass).  The downlink resolves
    its own knobs (``downlink_topk_frac``/``downlink_qsgd_bits``), falling
    back to the uplink values when unset."""
    topk_frac, qsgd_bits = fed.topk_frac, fed.qsgd_bits
    if direction == "downlink":
        if fed.downlink_topk_frac is not None:
            topk_frac = fed.downlink_topk_frac
        if fed.downlink_qsgd_bits is not None:
            qsgd_bits = fed.downlink_qsgd_bits
    if name == "none":
        return None
    if name == "identity":
        return IdentityCodec()
    if name == "topk":
        if direction == "uplink" and fed.sparse_uplink:
            return SparseTopKCodec(topk_frac)
        return DenseCodec(C.TopKCompressor(topk_frac))
    if name == "qsgd":
        return DenseCodec(C.QSGDCompressor(qsgd_bits))
    if name == "delta" or name.startswith("delta+"):
        if direction != "downlink":
            raise ValueError(
                f"{name!r} is a downlink (broadcast) codec: uplink deltas "
                f"already are deltas and ride the EF codecs")
        inner_name = "identity" if name == "delta" else name.partition("+")[2]
        if inner_name not in ("identity", "topk", "qsgd"):
            raise ValueError(f"unknown downlink compressor {name!r}; "
                             f"known: {', '.join(KNOWN_DOWNLINK)}")
        inner = make_codec(inner_name, fed, "downlink")
        from repro_torch.core.strategies import get_strategy  # layering
        strategy = get_strategy(fed.strategy)
        derive = None
        if hasattr(strategy, "ctx_from_broadcast_delta"):
            derive = functools.partial(strategy.ctx_from_broadcast_delta,
                                       fed=fed)
        return DeltaDownlinkCodec(inner, ctx_derive=derive, name=name)
    known = KNOWN_DOWNLINK if direction == "downlink" \
        else C.KNOWN_COMPRESSORS
    raise ValueError(f"unknown {direction} compressor {name!r}; "
                     f"known: {', '.join(known)}")


# ---------------------------------------------------------------------------
# the transport
# ---------------------------------------------------------------------------
class Transport:
    """Downlink broadcast codec, uplink delta codec, and measured-byte
    accounting for both directions.  Engines own their instance."""

    def __init__(self, fed, counters=None):
        if fed.sparse_uplink and fed.compressor not in ("topk", "none"):
            raise ValueError(
                f"sparse_uplink is the (value, index) top-k wire format; "
                f"compressor={fed.compressor!r} has no sparse path")
        self.fed = fed
        self.up = make_codec(fed.compressor, fed, "uplink")
        self.down = make_codec(fed.downlink_compressor, fed, "downlink")
        if fed.downlink_unicast:
            # unicast catch-up ships each client the chained delta against
            # their version; only the lossless delta family gives every
            # staleness level the exact θ_t from one broadcast tree
            if not (isinstance(self.down, DeltaDownlinkCodec)
                    and not self.down.lossy):
                raise ValueError(
                    f"downlink_unicast needs the lossless delta downlink "
                    f"(downlink_compressor='delta' / 'delta+identity'); "
                    f"got {fed.downlink_compressor!r}")
            if fed.resync_horizon < 0:
                raise ValueError(
                    f"resync_horizon must be >= 0, got {fed.resync_horizon}")
        self.ef_enabled = (self.up is not None and self.up.lossy
                           and fed.error_feedback)
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

    @property
    def sparse_native(self) -> bool:
        """True when the uplink wire is SparseLeaf pairs AND the config asks
        the server to aggregate them without decoding
        (``FedConfig.sparse_aggregate``)."""
        return (isinstance(self.up, SparseTopKCodec)
                and self.fed.sparse_aggregate)

    @property
    def needs_downlink_ref(self) -> bool:
        """True for the reference-coded (delta) downlink."""
        return isinstance(self.down, DeltaDownlinkCodec)

    @property
    def stateful_downlink(self) -> bool:
        """True when the downlink reconstruction depends on the reference
        (the lossy delta family); the lossless delta codec holds none."""
        return self.needs_downlink_ref and self.down.lossy

    def init_downlink_ref(self, params, ctx):
        """The round-0 reference (the out-of-band initial sync), or None
        when the downlink codec is stateless."""
        if not self.needs_downlink_ref:
            return None
        return self.down.init_ref(params, ctx)

    # --- the wire ------------------------------------------------------
    def broadcast(self, params, ctx, key=None, ref=None):
        """Downlink: (θ_t, client ctx) -> (params_w, ctx_w, new_ref), what
        the clients receive, plus the delta codec's advanced reference
        (None otherwise).  Lossless codecs return the inputs untouched."""
        if self.down is not None and self.down.lossy and key is None:
            # reusing one draw would correlate the rounding error across
            # rounds, and the downlink has no EF to drain the bias
            raise ValueError("a lossy downlink codec needs the round's "
                             "uniform draws; pass key= to broadcast()")
        if self.needs_downlink_ref:
            if self.down.lossy and ref is None:
                raise ValueError(
                    "the lossy delta downlink codec is stateful: pass ref= "
                    "(see Transport.init_downlink_ref) and thread the "
                    "returned reference into the next round")
            return self.down.broadcast(params, ctx, ref, key)
        if self.down is None or not self.down.lossy:
            return params, ctx, None
        rec = _roundtrip_one(self.down, {"params": params, "ctx": ctx}, key)
        return rec["params"], rec["ctx"], None

    def uplink(self, delta, ef, key=None):
        """The clients' uplink round trip (client-stacked trees) -> (dense
        reconstruction the server aggregates, new EF residual)."""
        if self.up is None:
            return delta, ef
        return self.up.roundtrip(delta, ef, key)

    def uplink_encode(self, delta, ef, key=None):
        if self.up is None:
            return delta, ef
        return self.up.encode(delta, ef, key)

    def uplink_decode(self, wire, like):
        if self.up is None:
            return wire
        return self.up.decode(wire, like)

    # --- host-side accounting ------------------------------------------
    def set_wire_templates(self, uplink_template, downlink_template=None):
        """Per-client wire sizes: uplink = the delta tree, downlink =
        {"params": θ_t, "ctx": ctx}."""
        self._up_raw = C.raw_nbytes(uplink_template)
        self._up_nbytes = (self._up_raw if self.up is None
                           else self.up.wire_nbytes(uplink_template))
        if downlink_template is not None:
            self._down_raw = C.raw_nbytes(downlink_template)
            self._down_nbytes = (self._down_raw if self.down is None
                                 else self.down.wire_nbytes(downlink_template))

    def account_uplink(self, n_clients: int = 1):
        self.counters.inc("transport.uplink_bytes",
                          n_clients * self._up_nbytes)
        self.counters.inc("transport.uplink_bytes_raw",
                          n_clients * self._up_raw)

    def account_downlink(self, n_clients: int = 1, resync: bool = False):
        """``resync=True`` marks broadcasts that ship the full tree instead
        of a delta (the delta codec's round-0 initial sync); stateless
        codecs ignore it."""
        nbytes = self._down_nbytes
        if resync and self.needs_downlink_ref:
            nbytes = self._down_raw
        self.counters.inc("transport.downlink_bytes", n_clients * nbytes)
        self.counters.inc("transport.downlink_bytes_raw",
                          n_clients * self._down_raw)

    def account_unicast(self, n_fresh: int, n_catchup: int, n_resync: int):
        """Per-client unicast downlink accounting: fresh clients already
        hold the version (0 bytes), catch-up clients get the chained delta
        (steady-state bytes), resync clients the full θ.  The raw baseline
        charges every dispatched client one full broadcast, as multicast
        does, so under full participation the two coincide."""
        measured = (n_catchup * self._down_nbytes
                    + n_resync * self._down_raw)
        n = n_fresh + n_catchup + n_resync
        self.counters.inc("transport.downlink_bytes", measured)
        self.counters.inc("transport.downlink_bytes_raw",
                          n * self._down_raw)

    # template-free probes
    def uplink_wire_nbytes(self, template) -> int:
        return (C.raw_nbytes(template) if self.up is None
                else self.up.wire_nbytes(template))

    def downlink_wire_nbytes(self, template) -> int:
        return (C.raw_nbytes(template) if self.down is None
                else self.down.wire_nbytes(template))


@functools.lru_cache(maxsize=None)
def _shim_transport(compressor: str, topk_frac: float, qsgd_bits: int,
                    error_feedback: bool, sparse_uplink: bool,
                    use_pallas: bool) -> Transport:
    from repro_torch.configs.base import FedConfig  # layering
    return Transport(FedConfig(
        compressor=compressor, topk_frac=topk_frac, qsgd_bits=qsgd_bits,
        error_feedback=error_feedback, sparse_uplink=sparse_uplink,
        use_pallas=use_pallas))


def shim_transport(fed) -> Transport:
    """The stateless cached instance behind the deprecated
    ``strategy.compress_delta`` (its counters unused there).  It is keyed
    on the uplink's fields only, not on the whole config, so a sweep over
    ``eta`` shares one instance; the config must be frozen, so those
    fields cannot change after the codec was built."""
    params = getattr(type(fed), "__dataclass_params__", None)
    if params is None or not params.frozen:
        raise TypeError(
            f"shim_transport needs a frozen config (got "
            f"{type(fed).__name__}): a mutable config could change its "
            f"wire knobs after the cached codec was built")
    return _shim_transport(fed.compressor, fed.topk_frac, fed.qsgd_bits,
                           fed.error_feedback, fed.sparse_uplink,
                           fed.use_pallas)


def downlink_nbytes(fed, params, ctx) -> int:
    """Measured bytes one client receives per round under fed's downlink
    codec (raw broadcast bytes when downlink compression is off)."""
    return Transport(fed).downlink_wire_nbytes({"params": params,
                                                "ctx": ctx})
