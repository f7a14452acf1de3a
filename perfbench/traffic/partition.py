"""Frozen copy of the port's Dirichlet partitioner.

Copied from ``src/repro_torch/data/partition.py`` at commit 9a9f55b
(``dirichlet_partition``), unchanged but for this docstring: per-class
client proportions drawn from Dir(alpha) (the paper's Sec. IV-C1).
"""
from __future__ import annotations

from typing import List

import numpy as np


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
