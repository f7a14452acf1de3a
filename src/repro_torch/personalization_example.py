"""Personalization via classifier calibration (paper Sec. IV-D / Fig. 7),
the port's counterpart of ``examples/personalization.py``, with the same
data, configs and printout: train FedADC+ globally, then calibrate each
client's head locally with the self-confidence KD regulariser and compare
per-client accuracy.

Run:  PYTHONPATH=src python -m repro_torch.personalization_example [--device cpu]

It runs on the GPU unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import FedConfig
from repro_torch.core.personalization import calibrate_head
from repro_torch.data.partition import class_counts, dirichlet_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.simulator import FederatedSimulator, SimConfig


def run(device=None):
    """Train FedADC+, calibrate the first eight clients' heads and print
    the table -> the per-client gains (personal − global accuracy)."""
    x, y, xt, yt = make_image_dataset(3000, 600, 10, image_size=16,
                                      noise=0.6, seed=0)
    parts = dirichlet_partition(y, 20, alpha=0.1, seed=0)
    fed = FedConfig(strategy="fedadc", local_steps=8, clients_per_round=4,
                    n_clients=20, eta=0.01, beta_global=0.7, beta_local=0.7,
                    distill=True)
    sim = SimConfig(model="cnn", n_classes=10, batch_size=32, rounds=20,
                    eval_every=20, cnn_width=8)
    s = FederatedSimulator(fed, sim, x, y, xt, yt, parts, device=device)
    s.run()
    counts = class_counts(y, parts, 10)

    print(f"{'client':>6} {'global':>8} {'personal':>9} {'gain':>7}")
    gains = []
    for ci, p in enumerate(parts[:8]):
        classes = np.unique(y[p])
        mask = np.isin(yt, classes)
        xte = torch.from_numpy(xt[mask]).to(s.device)
        yte = torch.from_numpy(yt[mask]).to(s.device)
        if not len(xte):
            continue

        def acc(params):
            with torch.no_grad():
                logits = s.apply(params, xte)
            return float(torch.mean((torch.argmax(logits, -1) == yte).float()))
        g = acc(s.params)
        pp = calibrate_head(s.params, s.apply, "head", x[p], y[p],
                            counts[ci], steps=60, batch_size=32, eta=0.05,
                            reg="kd")
        pa = acc(pp)
        gains.append(pa - g)
        print(f"{ci:>6} {g:>8.3f} {pa:>9.3f} {pa-g:>+7.3f}")
    print(f"\nmean gain: {np.mean(gains):+.3f} "
          f"(paper: +3.3–4.1% on CIFAR-100; calibration is repeatable when "
          f"local statistics change)")
    return gains


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    run(args.device)


if __name__ == "__main__":
    main()
