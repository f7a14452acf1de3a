"""The one traffic generator: it reads a configuration's ``data`` section
(what the clients hold) and makes it from ``--seed`` with the frozen
generators beside this file.

* ``"kind": "tokens"``: ``docs`` documents of ``seq_len`` tokens from
  ``make_token_dataset`` (Markov streams, each in one of ``n_domains``
  vocabulary bands), ordered by domain (stable), so the documents that one
  client takes in a round come from one or two domains: the clients are
  non-IID.  Every seed gives the same sizes.
* ``"kind": "images"``: ``n_train`` images of ``make_image_dataset`` and a
  Dirichlet(``alpha``) partition of them over ``n_clients``.
* A mix's further round inputs (``round_input``): ``client_ids``, each
  round's clients drawn without replacement from a ``pool``.

The seed is any whole number; numpy's ``RandomState`` takes 32 bits, so
it gets the seed folded into that range.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from perfbench.traffic.partition import dirichlet_partition
from perfbench.traffic.synthetic import make_image_dataset, make_token_dataset

# numpy seeds stay below 2**32 with room for the generators' own offsets
_NP_SEEDS = 4_000_000_000


def np_seed(seed: int, salt: int = 0) -> int:
    return (int(seed) * 1_000_003 + salt) % _NP_SEEDS


def token_docs(data: Dict, seq_len: int, vocab: int, seed: int) -> np.ndarray:
    """-> tokens (docs, seq_len) int32, ordered by domain."""
    tokens, domains = make_token_dataset(int(data["docs"]), seq_len, vocab,
                                         seed=np_seed(seed, 1),
                                         n_domains=int(data["n_domains"]))
    return tokens[np.argsort(domains, kind="stable")]


def image_clients(data: Dict, seed: int):
    """-> (x_train (N, S, S, 3) float32, y_train (N,) int32, parts: one
    index array per client)."""
    x, y, _, _ = make_image_dataset(
        int(data["n_train"]), 0, int(data["n_classes"]),
        image_size=int(data["image_size"]), n_modes=int(data["n_modes"]),
        noise=float(data["noise"]), seed=np_seed(seed, 2))
    parts = dirichlet_partition(y, int(data["n_clients"]),
                                float(data["alpha"]), seed=np_seed(seed, 3))
    return x, y, parts


def client_ids(spec: Dict, shape, seed: int, r: int) -> np.ndarray:
    """Round ``r``'s client ids, ``shape`` (pods, clients a pod), drawn
    without replacement from ``range(spec["pool"])``."""
    n = int(np.prod(shape))
    rng = np.random.RandomState(np_seed(seed, 5 + r))
    return rng.choice(int(spec["pool"]), n, replace=False).reshape(shape) \
        .astype(np.int64)


ROUND_INPUTS = {"client_ids": client_ids}


def round_input(name: str, spec: Dict, shape, seed: int, r: int):
    """A mix's further input of round ``r``, by its name."""
    if name not in ROUND_INPUTS:
        raise SystemExit(f"the traffic generator makes no round input "
                         f"{name!r}; it makes {sorted(ROUND_INPUTS)}")
    return ROUND_INPUTS[name](spec, shape, seed, r)
