"""Shared benchmark infrastructure (counterpart of ``benchmarks/common.py``).

The paper's experiments are CIFAR-10/100 with 100 clients × 500 rounds; each
benchmark runs a calibrated miniature (synthetic class-Gaussian images, 20
clients, tens of rounds) that preserves the qualitative orderings the paper
reports.  Every benchmark prints ``name,us_per_call,derived`` CSV rows
(us_per_call = wall-µs per communication round; derived = the table's
headline metric).

``run_fl`` and ``run_fl_async`` take ``device=``: ``None`` is the card (and
raises without one), ``"cpu"`` runs on the host.  On the card the clock
stops after ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import time
from typing import Dict

import torch

from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.data.partition import dirichlet_partition, sort_and_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.async_engine import AsyncFederatedSimulator
from repro_torch.federated.simulator import FederatedSimulator, SimConfig

_DATA_CACHE: Dict = {}


def dataset(n_classes=10, image_size=16, n_train=3000, n_test=600, seed=0,
            noise=0.6):
    key = (n_classes, image_size, n_train, n_test, seed, noise)
    if key not in _DATA_CACHE:
        _DATA_CACHE[key] = make_image_dataset(n_train, n_test, n_classes,
                                              image_size=image_size,
                                              seed=seed, noise=noise)
    return _DATA_CACHE[key]


def partitions(y, n_clients, kind, param, seed=0):
    if kind == "sort":
        return sort_and_partition(y, n_clients, int(param), seed)
    return dirichlet_partition(y, n_clients, float(param), seed)


def block_until_ready(device: torch.device) -> None:
    """Wait for the card's queued work before a clock is read (the port's
    ``jax.block_until_ready``); a no-op on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed_run(s, rounds) -> Dict:
    t0 = time.time()
    hist = s.run()
    block_until_ready(s.device)       # barrier before stopping the clock
    wall = time.time() - t0
    return {"acc": hist[-1]["acc"], "loss": hist[-1]["loss"],
            "us_per_round": wall / rounds * 1e6, "hist": hist, "sim": s}


def run_fl(strategy, parts, data, *, rounds=60, n_clients=20,
           clients_per_round=4, local_steps=8, eta=0.02, beta=0.7,
           batch_size=32, selector="random", distill=False,
           n_classes=10, model="cnn", seed=0, eval_every=None,
           extra_fed=None, telemetry=None, device=None) -> Dict:
    x, y, xt, yt = data
    fed_kw = dict(strategy=strategy, local_steps=local_steps,
                  clients_per_round=clients_per_round, n_clients=n_clients,
                  eta=eta, beta_global=beta, beta_local=beta,
                  distill=distill)
    if extra_fed:
        fed_kw.update(extra_fed)
    fed = FedConfig(**fed_kw)
    # explicit None-check: eval_every=0 must not silently become `rounds`
    sim = SimConfig(model=model, n_classes=n_classes, batch_size=batch_size,
                    rounds=rounds,
                    eval_every=rounds if eval_every is None else eval_every,
                    cnn_width=8, selector=selector, seed=seed)
    s = FederatedSimulator(fed, sim, x, y, xt, yt, parts,
                           telemetry=telemetry, device=device)
    return _timed_run(s, rounds)


def run_fl_async(strategy, parts, data, *, hetero: HeteroConfig, rounds=60,
                 n_clients=20, clients_per_round=4, local_steps=8, eta=0.02,
                 beta=0.7, batch_size=32, n_classes=10, model="cnn", seed=0,
                 extra_fed=None, telemetry=None, device=None) -> Dict:
    """run_fl's semi-async twin: the virtual-clock engine under a
    heterogeneous fleet, with the same calibrated miniature."""
    x, y, xt, yt = data
    fed_kw = dict(strategy=strategy, local_steps=local_steps,
                  clients_per_round=clients_per_round, n_clients=n_clients,
                  eta=eta, beta_global=beta, beta_local=beta)
    if extra_fed:
        fed_kw.update(extra_fed)
    fed = FedConfig(**fed_kw)
    sim = SimConfig(model=model, n_classes=n_classes, batch_size=batch_size,
                    rounds=rounds, eval_every=rounds, cnn_width=8, seed=seed)
    s = AsyncFederatedSimulator(fed, sim, hetero, x, y, xt, yt, parts,
                                telemetry=telemetry, device=device)
    return _timed_run(s, rounds)


def emit(name: str, us: float, derived) -> str:
    row = f"{name},{us:.0f},{derived}"
    print(row, flush=True)
    return row
