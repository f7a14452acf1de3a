"""Quickstart: FedADC vs FedAvg on a non-iid federation (the port's
counterpart of ``examples/quickstart.py``, with the same data, configs and
printout).

Reproduces the paper's core claim in miniature: under skewed client data
(sort-and-partition, s=2), embedding the server momentum into the local
iterations both accelerates training and controls client drift.

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
          [--telemetry-jsonl out.jsonl]

It runs on the GPU unless ``--device cpu`` is given.  ``--telemetry-jsonl``
turns on the per-round drift diagnostics (delta dispersion, momentum
alignment, update norm) and streams every telemetry event to the given
JSONL file; ``python -m repro_torch.telemetry.schema out.jsonl`` validates
it.
"""
from __future__ import annotations

import argparse
import contextlib

from repro_torch.configs.base import FedConfig
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.simulator import FederatedSimulator, SimConfig
from repro_torch.telemetry import Telemetry


def run(device=None, telemetry_jsonl=None):
    """Train FedAvg and FedADC, print the accuracy table -> the two eval
    histories by strategy name.  With ``telemetry_jsonl`` both runs stream
    their telemetry events (and a summary each) to that file."""
    x, y, xt, yt = make_image_dataset(3000, 600, n_classes=10,
                                      image_size=16, noise=0.6, seed=0)
    parts = sort_and_partition(y, n_clients=20, s=2, seed=0)
    sim = SimConfig(model="cnn", n_classes=10, batch_size=32, rounds=40,
                    eval_every=10, cnn_width=8)
    print(f"{'round':>6} " + "".join(f"{s:>10}" for s in
                                     ("fedavg", "fedadc")))
    histories = {}
    with (open(telemetry_jsonl, "w") if telemetry_jsonl
          else contextlib.nullcontext()) as sink:
        for strat, eta in (("fedavg", 0.05), ("fedadc", 0.01)):
            fed = FedConfig(strategy=strat, local_steps=8,
                            clients_per_round=4, n_clients=20, eta=eta,
                            beta_global=0.7, beta_local=0.7)
            tel = Telemetry(jsonl=sink, engine="sim") if sink else None
            s = FederatedSimulator(fed, sim, x, y, xt, yt, parts,
                                   telemetry=tel, device=device)
            histories[strat] = s.run()
            if tel is not None:
                tel.emit_summary()
    for i, h in enumerate(histories["fedavg"]):
        row = f"{h['round']:>6} "
        for strat in ("fedavg", "fedadc"):
            row += f"{histories[strat][i]['acc']:>10.3f}"
        print(row)
    final = {s: h[-1]["acc"] for s, h in histories.items()}
    print(f"\nFedADC − FedAvg = {final['fedadc'] - final['fedavg']:+.3f} "
          f"(paper: FedADC > FedAvg, gap grows with skew)")
    if telemetry_jsonl:
        print(f"telemetry events written to {telemetry_jsonl}")
    return histories


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--telemetry-jsonl", default=None,
                    help="enable telemetry and write events to this file")
    args = ap.parse_args(argv)
    run(args.device, args.telemetry_jsonl)


if __name__ == "__main__":
    main()
