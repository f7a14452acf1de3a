"""Sharding rules for the pod engine (counterpart of the JAX package's
``sharding/specs.py``), kept as data.

The port runs on one card, so nothing is sharded there; the tables say how
the reference lays a leaf out on its (data, model) mesh, or (pod, data,
model), so the dry-run (``launch/dryrun.py``) and the tests can plan and
count against the production meshes.  A spec is a tuple with one entry a
dimension: an axis name, a tuple of axis names, or ``None`` (replicated).
A mesh is anything with a ``.shape`` mapping of axis name to size:
``MeshShape`` here, built by ``launch/mesh.py``.

Layout:

* parameters — FSDP over "data" on the non-TP dim, tensor-parallel over
  "model" on the contraction-friendly dim (column-parallel for up/qkv
  projections, row-parallel for down/output projections, expert-parallel on
  the expert dim for MoE).
* FL server state (momentum m) — the spec of the parameter it mirrors.
* batches — client dims replicated/pod-sharded, sample dim over "data".
* decode caches — batch over "data" when divisible, else sequence; heads
  over "model" when divisible, else head_dim.

Every rule is divisibility-guarded: a dim that doesn't divide its mesh axis
falls back to replicated.  Key paths are the port's parameter tree's, the
reference's one to one (``convert.py``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

from repro_torch.core.tree import tree_map_with_path

# param dict keys (the name of the dict that owns the "w"/"b" leaf)
COLUMN_PARALLEL = {
    "wq", "wk", "wv", "wuq", "wuk", "wuv", "wdq", "wdkv", "gate", "up",
    "in_proj", "wx", "w_if", "fc1", "f1", "f2", "f3", "head", "router",
    "vis_proj", "lm_head",
}
ROW_PARALLEL = {"wo", "down", "out_proj", "fc2"}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes: nothing allocated, no device."""
    axes: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices the mesh spans."""
        return math.prod(self.sizes)


def _axis(mesh, name):
    if isinstance(name, tuple):
        n = 1
        for a in name:
            n *= _axis(mesh, a)
        return n
    return mesh.shape[name] if name in mesh.shape else 1


def _path_keys(path) -> Tuple[str, ...]:
    return tuple(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)


def spec_for_param(path, shape, mesh, fsdp="data", tp="model",
                   mode="train"):
    """mode="train": FSDP×TP (params gathered per use).  mode="serve": no
    FSDP — dense weights TP-sharded and replicated over "data", MoE experts
    expert-parallel over "data" × TP over "model"."""
    keys = _path_keys(path)
    owner = keys[-2] if len(keys) >= 2 else keys[-1]
    leafname = keys[-1]
    rank = len(shape)
    if mode == "serve":
        fsdp = None

    def guard(spec):
        # enforce divisibility dim by dim; pad leading None for stacked runs
        out = [None] * rank
        trailing = len(spec)
        for i, ax in enumerate(spec):
            dim_idx = rank - trailing + i
            if dim_idx < 0 or ax is None:
                continue
            if shape[dim_idx] % max(_axis(mesh, ax), 1) == 0:
                out[dim_idx] = ax
        return tuple(out)

    if leafname == "emb":
        return guard((tp, fsdp))
    if owner == "experts":                       # (E, d, f) / (E, f, d)
        if mode == "serve":                      # expert-parallel over data
            if leafname in ("gate", "up"):
                return guard(("data", None, tp))
            return guard(("data", tp, None))     # down
        if leafname in ("gate", "up"):
            return guard((tp, fsdp, None))
        return guard((tp, None, fsdp))           # down
    if leafname in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "scale",
                    "bias", "r"):
        return (None,) * rank
    if leafname == "pos_dec":
        return guard((None, fsdp))
    if leafname == "b":
        return (None,) * rank
    if leafname == "w" or owner in COLUMN_PARALLEL | ROW_PARALLEL:
        name = owner if leafname in ("w", "b") else leafname
        if name in COLUMN_PARALLEL:
            return guard((fsdp, tp))
        if name in ROW_PARALLEL:
            return guard((tp, fsdp))
    return (None,) * rank


def param_shardings(params_shapes, mesh, fsdp="data", tp="model",
                    mode="train", fsdp_over_pod=False, tp_off=False):
    """A tree of tensors (``meta`` ones will do) -> the tree of their
    specs.  ``fsdp_over_pod`` shards FSDP over ("pod", "data");
    ``tp_off`` drops the model axis (pure FSDP)."""
    if fsdp_over_pod and "pod" in mesh.shape:
        fsdp = ("pod", "data")
    if tp_off:
        tp = None
    return tree_map_with_path(
        lambda path, leaf: spec_for_param(path, tuple(leaf.shape), mesh,
                                          fsdp, tp, mode=mode),
        params_shapes)


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------
def spec_for_cache(path, shape, mesh, data="data", tp="model"):
    keys = _path_keys(path)
    leafname = keys[-1]
    rank = len(shape)
    if leafname == "kpos" or rank <= 1:
        return (None,) * rank

    def pick(dims):
        """dims: list of (dim_idx, axis_pref) tried in order per axis."""
        out = [None] * rank
        used = set()
        for dim_idx, ax in dims:
            if dim_idx >= rank or ax in used or out[dim_idx] is not None:
                continue
            if shape[dim_idx] % max(_axis(mesh, ax), 1) == 0 \
                    and shape[dim_idx] >= _axis(mesh, ax):
                out[dim_idx] = ax
                used.add(ax)
        return tuple(out)

    if leafname in ("k", "v", "xk", "xv"):       # (L?, B, S, Hk, hd)
        b, s, h, d = rank - 4, rank - 3, rank - 2, rank - 1
        return pick([(b, data), (s, data), (h, tp), (d, tp)])
    if leafname in ("c_kv", "k_rope"):           # (L?, B, S, r)
        b, s, r = rank - 3, rank - 2, rank - 1
        return pick([(b, data), (s, data), (r, tp)])
    if leafname == "h":                          # (L?, B, H, N, P)
        b, h, n, p = rank - 4, rank - 3, rank - 2, rank - 1
        return pick([(b, data), (h, tp), (p, tp), (n, data)])
    if leafname == "C":                          # mlstm (L?, B, H, P, P)
        b, h, p1, p2 = rank - 4, rank - 3, rank - 2, rank - 1
        return pick([(b, data), (h, tp), (p1, tp), (p2, data)])
    if leafname in ("n", "m", "conv", "c"):
        # generic: try the batch dim, then the last dim
        return pick([(rank - 3 if rank >= 3 else 0, data), (rank - 1, tp)])
    return (None,) * rank


def cache_shardings(cache_shapes, mesh, data="data", tp="model"):
    return tree_map_with_path(
        lambda path, leaf: spec_for_cache(path, tuple(leaf.shape), mesh,
                                          data, tp),
        cache_shapes)


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------
def train_batch_spec(mesh, multi_pod: bool):
    """tokens/labels (CP, CS, H, b, L): client-parallel dim over "pod"."""
    lead = "pod" if (multi_pod and "pod" in mesh.shape) else None
    return (lead, None, None, "data", None)


def serve_batch_spec(mesh, batch: int, multi_pod: bool):
    if multi_pod and "pod" in mesh.shape and batch % (
            _axis(mesh, "pod") * _axis(mesh, "data")) == 0:
        return (("pod", "data"), None)
    if batch % _axis(mesh, "data") == 0:
        return ("data", None)
    return (None, None)
