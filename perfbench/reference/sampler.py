"""The synchronous simulator's client picks and batches, drawn again.

Written from the sampling rule the paper's setup states and the port's
simulator documents: one ``np.random.RandomState(seed)`` stream; each
round picks |S| of the N clients uniformly without replacement, then for
each pick in order draws H·b of its examples from as many fresh
permutations of its index set as it takes to have H·b of them, cut into
H batches of b.  Numpy only; imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np


class RoundSampler:
    def __init__(self, seed: int, parts, clients: int, steps: int,
                 batch: int):
        self.rng = np.random.RandomState(seed)
        self.parts, self.k, self.h, self.b = parts, clients, steps, batch

    def next_round(self) -> np.ndarray:
        """-> indices (|S|, H, b) into the training set."""
        picks = self.rng.choice(len(self.parts), size=self.k, replace=False)
        need = self.h * self.b
        out = []
        for c in picks:
            idx = self.parts[int(c)]
            reps = max(math.ceil(need / len(idx)), 1)
            pool = np.concatenate([self.rng.permutation(idx)
                                   for _ in range(reps)])
            out.append(pool[:need].reshape(self.h, self.b))
        return np.stack(out)
