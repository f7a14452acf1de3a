"""Client selection (Sec. IV-E further discussion).

* ``random``          — uniform sampling of cN clients (FedAvg default).
* ``class_coverage``  — data-aware selection: rejection-sample random
  subsets for a bounded number of tries, then finish the best draw with a
  strict-improvement single-swap hill climb until the union of the selected
  clients' data covers every class (or no swap helps), mitigating the
  momentum bias the paper describes for small participation ratios
  (reported +2.1% final accuracy on CIFAR-10 s=2, C=0.1).

Both selectors are pure functions of (rng state, arguments): the same
RandomState seed and the same counts produce the same picks (pinned in
tests).  A numpy copy of the JAX package's ``core/selection.py``, so both
packages draw the same picks from the same stream.
"""
from __future__ import annotations

import numpy as np


def random_selection(rng: np.random.RandomState, n_clients: int,
                     n_pick: int) -> np.ndarray:
    return rng.choice(n_clients, size=n_pick, replace=False)


def class_coverage_selection(rng: np.random.RandomState, n_clients: int,
                             n_pick: int, counts: np.ndarray,
                             max_tries: int = 200) -> np.ndarray:
    """counts (n_clients, n_classes).  Rejection-sample up to `max_tries`
    draws for a pick whose union covers every class; if none does, finish
    the best-coverage draw with a strict-improvement single-swap hill climb:
    only swaps that strictly raise coverage — recomputed from the
    candidate pick, never stale bookkeeping — are applied, so the loop
    terminates at full coverage or a single-swap local optimum."""
    n_classes = counts.shape[1]
    best, best_cov = None, -1
    for _ in range(max_tries):
        pick = rng.choice(n_clients, size=n_pick, replace=False)
        cov = int((counts[pick].sum(0) > 0).sum())
        if cov == n_classes:
            return pick
        if cov > best_cov:
            best, best_cov = pick, cov
    # greedy repair: hill-climb on single swaps, recomputing coverage from
    # the CANDIDATE pick each iteration (a swap may drop the removed
    # member's classes, so stale `missing` bookkeeping over-claims).  Only
    # strictly-improving swaps are applied, so the loop terminates with a
    # pick that is single-swap locally optimal.
    pick = list(best)
    outside = [c for c in range(n_clients) if c not in set(pick)]
    rng.shuffle(outside)
    improved = True
    while improved:
        cur_cov = int((counts[pick].sum(0) > 0).sum())
        if cur_cov == n_classes:
            break
        improved = False
        for ci, cand in enumerate(outside):
            best_j, best_c = None, cur_cov
            for j in range(len(pick)):
                rest = pick[:j] + pick[j + 1:] + [cand]
                cov = int((counts[rest].sum(0) > 0).sum())
                if cov > best_c:
                    best_j, best_c = j, cov
            if best_j is not None:
                outside[ci] = pick[best_j]
                pick = pick[:best_j] + pick[best_j + 1:] + [cand]
                improved = True
                break
    return np.array(pick)


SELECTORS = {"random": random_selection,
             "class_coverage": class_coverage_selection}
