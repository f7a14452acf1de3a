"""Frozen copies of the port's synthetic data generators.

Copied from ``src/repro_torch/data/synthetic.py`` at commit 9a9f55b
(``make_image_dataset``, ``make_token_dataset``), unchanged but for this
docstring, so that a later change to the program cannot move the
benchmark's traffic.  Numpy only: the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def make_image_dataset(n_train: int, n_test: int, n_classes: int,
                       image_size: int = 32, n_modes: int = 3,
                       noise: float = 0.35, seed: int = 0
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """-> (x_train (N,H,W,3), y_train, x_test, y_test), float32 in ~[-1,1]."""
    rng = np.random.RandomState(seed)
    H = image_size
    # smooth class templates: low-freq random fields
    freq = rng.randn(n_classes, n_modes, 4, 4, 3).astype(np.float32)
    templates = np.zeros((n_classes, n_modes, H, H, 3), np.float32)
    for c in range(n_classes):
        for m in range(n_modes):
            up = np.kron(freq[c, m], np.ones((H // 4, H // 4, 1), np.float32))
            templates[c, m] = up
    templates /= (np.abs(templates).max() + 1e-6)

    def _sample(n, seed_off):
        r = np.random.RandomState(seed + seed_off)
        y = r.randint(0, n_classes, size=n)
        m = r.randint(0, n_modes, size=n)
        x = templates[y, m] + noise * r.randn(n, H, H, 3).astype(np.float32)
        return x.astype(np.float32), y.astype(np.int32)

    x_tr, y_tr = _sample(n_train, 1)
    x_te, y_te = _sample(n_test, 2)
    return x_tr, y_tr, x_te, y_te


def make_token_dataset(n_docs: int, seq_len: int, vocab: int, seed: int = 0,
                       n_domains: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Markov token streams with per-domain transition structure; the domain
    id doubles as the 'class' for non-iid client partitioning.
    -> (tokens (n_docs, seq_len) int32, domain (n_docs,) int32)."""
    rng = np.random.RandomState(seed)
    doms = rng.randint(0, n_domains, size=n_docs)
    # each domain prefers a band of the vocab
    tokens = np.zeros((n_docs, seq_len), np.int32)
    band = max(vocab // n_domains, 8)
    for i in range(n_docs):
        d = doms[i]
        lo = (d * band) % max(vocab - band, 1)
        t = rng.randint(lo, lo + band)
        seq = [t]
        for _ in range(seq_len - 1):
            if rng.rand() < 0.8:   # stay in band, markov-ish walk
                t = lo + (t - lo + rng.randint(-3, 4)) % band
            else:
                t = rng.randint(0, vocab)
            seq.append(t)
        tokens[i] = np.array(seq, np.int32)
    return tokens, doms.astype(np.int32)
