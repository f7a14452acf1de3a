"""Semi-async FedADC under a straggler fleet (the port's counterpart of
``examples/async_straggler.py``, with the same data, configs and printout).

A quarter of the clients run 4x slower than the rest.  The synchronous
barrier (buffer_k = clients_per_round) waits for the slowest client of
every round; the semi-async engine applies the server update as soon as
the fastest half of the wave arrives, discounting the momentum share of
any stale delta that trickles in later.  Both run a top-k 10% + error
feedback uplink and the unicast delta downlink: every dispatched client is
served against the last server version it saw, a chained delta when it is
at most ``resync_horizon`` versions stale and the full θ beyond that, so
the down-MB column is the measured per-client unicast bytes.  Accuracy is
printed against the virtual clock (one unit = one local step on the
reference client).

Run:  PYTHONPATH=src python -m repro_torch.async_straggler_example [--device cpu]
          [--telemetry-jsonl out.jsonl]

It runs on the GPU unless ``--device cpu`` is given.  ``--telemetry-jsonl``
streams every telemetry event, the async flushes' staleness and drift
diagnostics included, to the given JSONL file.
"""
from __future__ import annotations

import argparse
import contextlib
from itertools import zip_longest

from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.data.partition import sort_and_partition
from repro_torch.data.synthetic import make_image_dataset
from repro_torch.federated.async_engine import AsyncFederatedSimulator
from repro_torch.federated.simulator import SimConfig
from repro_torch.telemetry import Telemetry


def run(device=None, telemetry_jsonl=None):
    """Run the synchronous barrier and the semi-async engine, print the
    tables -> {"sync": engine, "semi": engine}.  With ``telemetry_jsonl``
    both engines stream their telemetry events (and a summary each) to
    that file."""
    x, y, xt, yt = make_image_dataset(3000, 600, n_classes=10,
                                      image_size=16, noise=0.6, seed=0)
    parts = sort_and_partition(y, n_clients=20, s=2, seed=0)
    hetero = HeteroConfig(enabled=True, speed_dist="bimodal",
                          straggler_frac=0.25, straggler_slowdown=4.0,
                          seed=0)
    print(f"{'mode':>6} {'rounds':>7} {'virtual time':>13} {'final acc':>10}"
          f" {'up MB':>7} {'down MB':>8} {'catchup':>8} {'resync':>7}")
    engines = {}
    with (open(telemetry_jsonl, "w") if telemetry_jsonl
          else contextlib.nullcontext()) as sink:
        for mode, buffer_k, rounds in (("sync", 0, 20), ("semi", 4, 60)):
            fed = FedConfig(strategy="fedadc", local_steps=8,
                            clients_per_round=8, n_clients=20, eta=0.02,
                            beta_global=0.7, beta_local=0.7,
                            buffer_k=buffer_k, staleness_mode="poly",
                            staleness_factor=0.5, compressor="topk",
                            topk_frac=0.1, error_feedback=True,
                            downlink_compressor="delta",
                            downlink_unicast=True, resync_horizon=2)
            sim = SimConfig(model="cnn", n_classes=10, batch_size=32,
                            rounds=rounds, eval_every=5, cnn_width=8, seed=0)
            tel = Telemetry(jsonl=sink, engine=f"async-{mode}") \
                if sink else None
            eng = AsyncFederatedSimulator(fed, sim, hetero, x, y, xt, yt,
                                          parts, telemetry=tel,
                                          device=device)
            hist = eng.run()
            engines[mode] = eng
            if tel is not None:
                tel.emit_summary()
            print(f"{mode:>6} {hist[-1]['round']:>7} "
                  f"{hist[-1]['t']:>13.0f} {hist[-1]['acc']:>10.3f} "
                  f"{eng.uplink_bytes/2**20:>7.1f} "
                  f"{eng.downlink_bytes/2**20:>8.1f} "
                  f"{int(eng.refs.catchups):>8} {int(eng.refs.resyncs):>7}")
    print("\nper-client unicast downlink (semi-async run): stragglers fall "
          "past the\nhorizon and pay full-θ resyncs; fast clients ride "
          "cheap chained deltas")
    refs = engines["semi"].refs
    print(f"{'client':>7} {'catchups':>9} {'resyncs':>8} {'down MB':>8}")
    for c in sorted(refs.client_bytes):
        print(f"{c:>7} {refs.client_catchups.get(c, 0):>9} "
              f"{refs.client_resyncs.get(c, 0):>8} "
              f"{refs.client_bytes[c]/2**20:>8.1f}")
    print("\naccuracy vs virtual time (semi-async reaches any level sooner):")
    print(f"{'sync t':>8} {'acc':>8}    | {'semi t':>8} {'acc':>8}")
    for hs, ha in zip_longest(engines["sync"].history,
                              engines["semi"].history):
        left = f"{hs['t']:>8.0f} {hs['acc']:>8.3f}" if hs else " " * 17
        right = f"{ha['t']:>8.0f} {ha['acc']:>8.3f}" if ha else ""
        print(f"{left}    | {right}")
    if telemetry_jsonl:
        print(f"telemetry events written to {telemetry_jsonl}")
    return engines


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
