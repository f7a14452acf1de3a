"""Nested parameter dicts <-> flat ``{"a/b/c": tensor}`` dicts."""
from __future__ import annotations

from typing import Dict


def flatten(tree, prefix: str = "") -> Dict:
    out = {}
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, path))
        else:
            out[path] = v
    return out


def unflatten(flat: Dict) -> Dict:
    out: Dict = {}
    for path, v in flat.items():
        node = out
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def leaf_norms(tree: Dict) -> Dict[str, float]:
    """-> {path: the leaf's 2-norm, in float32}."""
    import torch
    return {k: float(torch.linalg.vector_norm(v.float())) for k, v in
            tree.items()}
