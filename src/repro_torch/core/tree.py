"""Tree algebra over nested dicts of tensors (params, momenta and deltas all
share the model's key paths, e.g. ``{"c1": {"w": ..., "b": ...}}``).

Counterpart of the JAX package's ``core/tree.py``.  The simulator keeps the
round's clients stacked along a leading axis K on every leaf; the
``*_per_client`` functions reduce over everything but that axis, where the
reference gets the same per-client result from ``vmap``.
"""
from __future__ import annotations

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf by leaf over trees with the same dict structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves(tree):
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def zeros_like(t):
    return tree_map(torch.zeros_like, t)


def add(a, b):
    return tree_map(torch.add, a, b)


def sub(a, b):
    return tree_map(torch.sub, a, b)


def scale(t, s):
    return tree_map(lambda x: x * s, t)


def axpy(a, x, y):
    """a*x + y."""
    return tree_map(lambda xi, yi: a * xi + yi, x, y)


def dot(a, b):
    return sum(torch.sum(x.float() * y.float())
               for x, y in zip(leaves(a), leaves(b)))


def sq_norm(t):
    return dot(t, t)


def sq_norm_per_client(t):
    """(K,) squared norm of each client's slice of a client-stacked tree."""
    return sum(torch.sum(x.float().reshape(x.shape[0], -1) ** 2, dim=1)
               for x in leaves(t))


def clip_per_client(t, max_norm):
    """Clip each client's slice of a client-stacked tree to global norm
    ``max_norm`` (the reference's ``clip_by_global_norm`` under vmap):
    scale by min(1, max_norm / max(‖g_k‖, 1e-12))."""
    n = torch.sqrt(sq_norm_per_client(t))
    s = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    return tree_map(lambda x: x * s.reshape((-1,) + (1,) * (x.dim() - 1)), t)


def cast(t, dtype):
    return tree_map(lambda x: x.to(dtype), t)



def tree_map_with_path(fn, tree, path=()):
    """``tree_map`` over one tree whose ``fn`` also gets the leaf's key path
    (the tuple of dict keys, e.g. ``("c1", "w")``), so a leaf is found by
    name whatever the dict order."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def unzip2(pairs):
    """A tree of (a, b) pairs -> (tree of a, tree of b)."""
    return tree_map(lambda p: p[0], pairs), tree_map(lambda p: p[1], pairs)
