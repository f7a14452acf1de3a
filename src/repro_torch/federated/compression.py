"""Uplink delta compressors with per-client error feedback (counterpart of
the JAX package's ``federated/compression.py``).

Compressors (``FedConfig.compressor``):

* ``none``     — the codec is bypassed entirely.
* ``identity`` — goes through the codec but is lossless; runs equal
  ``none``'s bit for bit.
* ``topk``     — top-k magnitude sparsification: per leaf, the k =
  ⌈topk_frac·n⌉ largest-|v| entries survive; the wire carries (value, index)
  pairs, ⌈log₂ n⌉ bits per index.
* ``qsgd``     — QSGD stochastic uniform quantisation: magnitudes scaled by
  the per-leaf max into ``2^qsgd_bits − 1`` levels and stochastically
  rounded; the wire carries ``qsgd_bits``+sign per entry plus one f32 scale
  per leaf.

Error feedback: the client quantises v_t = Δ_t + e_{t−1} and keeps
e_t = v_t − q(v_t), the exact residual, to re-inject next round.

Where the reference compresses one client's tree under ``vmap``, the port
compresses a tree whose every leaf carries the round's clients on a leading
axis: the top-k threshold (one batched ``torch.topk``) and the QSGD scale
(one ``amax``) are per client row, and each stacked leaf is one kernel
launch.  ``wire_nbytes`` counts one client's wire from an unstacked
template, as the reference does.

Random draws.  The reference draws QSGD's uniforms from JAX keys, which
torch cannot reproduce.  Here they enter as an operand: ``compress`` takes
a ``UniformDraws`` — a callable ``(leaf path, shape, dtype) -> uniforms in
[0, 1)`` scoped to one codec call — and by default the draws come from one
``torch.Generator`` on the device (``GeneratorUniforms``).  A test hands in
the reference's own draws instead, matched by key path.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as T
from repro_torch.kernels import ops

KNOWN_COMPRESSORS = ("none", "identity", "topk", "qsgd")


class SparseLeaf(NamedTuple):
    """One leaf's sparse wire: the k surviving (value, index) pairs of each
    client row — values (K, k) in the leaf dtype, indices (K, k) int32 flat
    indices into the leaf.  A tuple, so the port's dict-tree maps treat it
    as one leaf."""
    values: torch.Tensor
    indices: torch.Tensor


def is_sparse_leaf(x) -> bool:
    return isinstance(x, SparseLeaf)


def is_sparse_tree(tree) -> bool:
    """True when the tree's leaves are SparseLeaf wires (the sparse-native
    uplink); False for dense trees."""
    return any(is_sparse_leaf(leaf) for leaf in T.leaves(tree))


# ---------------------------------------------------------------------------
# where the QSGD draws come from
# ---------------------------------------------------------------------------
# source(name, shape, dtype, device) -> uniforms in [0, 1); `name` is the
# call's scope followed by the leaf's key path
UniformSource = Callable[[Tuple, torch.Size, torch.dtype, torch.device],
                         torch.Tensor]


class GeneratorUniforms:
    """The default uniform source: one ``torch.Generator`` on the device,
    seeded once.  Names are ignored; draws are taken in call order."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def __call__(self, name, shape, dtype, device):
        return torch.rand(shape, generator=self.gen, dtype=dtype,
                          device=device)


class UniformDraws:
    """The uniform draws of one codec call: ``draws(path, shape, dtype)``
    asks the source for the leaf at ``path`` under this call's scope (for
    example ``(round, "uplink")``); ``fold(tag)`` narrows the scope, as
    ``jax.random.fold_in`` does for a key."""

    def __init__(self, source: UniformSource, scope: Tuple, device):
        self.source, self.scope, self.device = source, tuple(scope), device

    def fold(self, tag) -> "UniformDraws":
        return UniformDraws(self.source, self.scope + (tag,), self.device)

    def __call__(self, path: str, shape, dtype) -> torch.Tensor:
        return self.source(self.scope + (path,), torch.Size(shape), dtype,
                           self.device)


# ---------------------------------------------------------------------------
# byte accounting
# ---------------------------------------------------------------------------
def _leaf_elems(leaf) -> int:
    return math.prod(leaf.shape)


def _leaf_itembits(leaf) -> int:
    return leaf.dtype.itemsize * 8


def raw_nbytes(tree) -> int:
    """Uncompressed wire size of a tree of tensors."""
    return sum(_leaf_elems(x) * x.dtype.itemsize for x in T.leaves(tree))


# ---------------------------------------------------------------------------
# compressors
# ---------------------------------------------------------------------------
class Compressor:
    """``compress`` works on client-stacked trees; ``wire_nbytes`` counts
    one client's wire from an unstacked template."""
    name = "base"
    lossy = True

    def compress(self, delta, ef, key):
        """(delta, ef trees, UniformDraws) -> (decompressed q, new ef = the
        exact residual (delta + ef) − q)."""
        raise NotImplementedError

    def wire_nbytes(self, tree) -> int:
        raise NotImplementedError


class IdentityCompressor(Compressor):
    name = "identity"
    lossy = False

    def compress(self, delta, ef, key):
        return delta, ef

    def wire_nbytes(self, tree) -> int:
        return raw_nbytes(tree)


def _rows(x):
    return x.reshape(x.shape[0], -1)


class TopKCompressor(Compressor):
    """Top-k magnitude sparsification, k per leaf per client: the exact
    threshold τ (each row's k-th largest |v|, one batched ``torch.topk``)
    feeds the streaming threshold-select kernel."""
    name = "topk"

    def __init__(self, frac: float):
        if not 0.0 < frac <= 1.0:
            raise ValueError(f"topk_frac must be in (0, 1]; got {frac}")
        self.frac = frac

    def _k(self, n: int) -> int:
        return max(1, int(math.ceil(self.frac * n)))

    def compress(self, delta, ef, key):
        def tau(x):
            flat = torch.abs(_rows(x))
            return torch.topk(flat, self._k(flat.shape[1]), dim=1).values[:, -1]
        v = T.add(delta, ef)
        return ops.topk_compress_tree(v, T.tree_map(tau, v))

    def wire_nbytes(self, tree) -> int:
        bits = 0
        for leaf in T.leaves(tree):
            n = _leaf_elems(leaf)
            idx_bits = max(1, math.ceil(math.log2(n))) if n > 1 else 1
            bits += self._k(n) * (_leaf_itembits(leaf) + idx_bits) + 32
        return (bits + 7) // 8


class QSGDCompressor(Compressor):
    """QSGD stochastic uniform quantisation, per-leaf per-client max scale."""
    name = "qsgd"

    def __init__(self, bits: int):
        if bits < 1:
            raise ValueError(f"qsgd_bits must be >= 1; got {bits}")
        self.bits = bits
        self.levels = (1 << bits) - 1     # magnitude levels; sign is separate

    def compress(self, delta, ef, key):
        v = T.add(delta, ef)
        u = T.tree_map_with_path(
            lambda path, x: key("/".join(path), x.shape, x.dtype), v)
        return ops.qsgd_compress_tree(v, u, self.levels)

    def wire_nbytes(self, tree) -> int:
        bits = sum(_leaf_elems(leaf) * (self.bits + 1) + 32
                   for leaf in T.leaves(tree))
        return (bits + 7) // 8


@functools.lru_cache(maxsize=None)
def _get_compressor(name: str, topk_frac: float,
                    qsgd_bits: int) -> Optional[Compressor]:
    if name == "none":
        return None
    if name == "identity":
        return IdentityCompressor()
    if name == "topk":
        return TopKCompressor(topk_frac)
    if name == "qsgd":
        return QSGDCompressor(qsgd_bits)
    raise ValueError(f"unknown compressor {name!r}; "
                     f"known: {', '.join(KNOWN_COMPRESSORS)}")


def get_compressor(fed) -> Optional[Compressor]:
    """FedConfig -> Compressor (None when compressor='none': the codec is
    bypassed).  Cached on the wire knobs only, not on the whole config."""
    return _get_compressor(fed.compressor, fed.topk_frac, fed.qsgd_bits)


def uplink_nbytes(fed, params) -> int:
    """Measured bytes one client uploads per round under fed's compressor
    (raw delta bytes when compression is off)."""
    comp = get_compressor(fed)
    return raw_nbytes(params) if comp is None else comp.wire_nbytes(params)
