"""Non-iid client partitioners from the paper:

* sort-and-partition(s): sort by label, split into blocks, give each client
  blocks from at most `s` distinct labels (Sec. IV-B2).
* Dirichlet(α): per-class proportions sampled from Dir(α) (Sec. IV-C1).
"""
from __future__ import annotations

from typing import List

import numpy as np


def sort_and_partition(labels: np.ndarray, n_clients: int, s: int,
                       seed: int = 0) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    order = np.argsort(labels, kind="stable")
    n_blocks = n_clients * s
    blocks = np.array_split(order, n_blocks)
    perm = rng.permutation(n_blocks)
    parts = [np.concatenate([blocks[perm[c * s + j]] for j in range(s)])
             for c in range(n_clients)]
    return [rng.permutation(p) for p in parts]


def dirichlet_partition(labels: np.ndarray, n_clients: int, alpha: float,
                        seed: int = 0, min_size: int = 2) -> List[np.ndarray]:
    rng = np.random.RandomState(seed)
    n_classes = int(labels.max()) + 1
    while True:
        parts = [[] for _ in range(n_clients)]
        for c in range(n_classes):
            idx = np.where(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet([alpha] * n_clients)
            cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
            for ci, chunk in enumerate(np.split(idx, cuts)):
                parts[ci].append(chunk)
        parts = [np.concatenate(p) for p in parts]
        if min(len(p) for p in parts) >= min_size:
            return [rng.permutation(p) for p in parts]
        seed += 1
        rng = np.random.RandomState(seed)


def class_counts(labels: np.ndarray, parts: List[np.ndarray],
                 n_classes: int) -> np.ndarray:
    """-> (n_clients, n_classes) float32 counts (the γ_{i,k} numerators)."""
    out = np.zeros((len(parts), n_classes), np.float32)
    for i, p in enumerate(parts):
        for c, n in zip(*np.unique(labels[p], return_counts=True)):
            out[i, int(c)] = n
    return out
