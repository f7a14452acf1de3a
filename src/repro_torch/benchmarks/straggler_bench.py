"""Straggler bench: simulated wall-clock-to-accuracy, synchronous vs
semi-async FedADC under a 4× straggler fleet (DESIGN.md §Heterogeneity).

The synchronous engine barriers every round on the slowest selected client,
so a 25% population of 4×-slower stragglers inflates round time ~4× whenever
one is sampled; the semi-async engine flushes the fastest buffer_k deltas and
lets stragglers arrive late with staleness-discounted momentum.  Reported:
virtual time (units = local steps on the reference client) to reach the
target accuracy, and final accuracy.

CSV rows reuse the ``name,us_per_call,derived`` format with the middle
column holding raw virtual time and `derived` the final accuracy.
"""
from __future__ import annotations

from repro_torch.benchmarks.common import dataset, emit, partitions
from repro_torch.configs.base import FedConfig, HeteroConfig
from repro_torch.federated.async_engine import AsyncFederatedSimulator
from repro_torch.federated.simulator import SimConfig

TARGET_ACC = 0.30
STRAGGLERS = HeteroConfig(enabled=True, speed_dist="bimodal",
                          straggler_frac=0.25, straggler_slowdown=4.0,
                          seed=0)


def run_mode(data, parts, *, buffer_k, rounds, eval_every=2, device=None):
    x, y, xt, yt = data
    # both modes keep the same fleet of 8 clients in flight; sync barriers
    # on all 8, semi-async flushes on the fastest 4
    fed = FedConfig(strategy="fedadc", local_steps=8, clients_per_round=8,
                    n_clients=20, eta=0.02, beta_global=0.7, beta_local=0.7,
                    buffer_k=buffer_k, staleness_mode="poly",
                    staleness_factor=0.5)
    sim = SimConfig(model="cnn", n_classes=10, batch_size=32, rounds=rounds,
                    eval_every=eval_every, cnn_width=8, seed=0)
    eng = AsyncFederatedSimulator(fed, sim, STRAGGLERS, x, y, xt, yt, parts,
                                  device=device)
    hist = eng.run()
    t_target = next((h["t"] for h in hist if h["acc"] >= TARGET_ACC),
                    float("inf"))
    return hist, t_target, eng


def main(rows=None, device=None):
    rows = rows if rows is not None else []
    data = dataset()
    parts = partitions(data[1], 20, "sort", 2)
    # synchronous barrier: buffer_k == clients_per_round
    h_sync, t_sync, _ = run_mode(data, parts, buffer_k=0, rounds=20,
                                 device=device)
    # semi-async: flush on the fastest half of the wave
    h_semi, t_semi, eng = run_mode(data, parts, buffer_k=4, rounds=60,
                                   device=device)
    rows.append(emit("straggler.sync.t_to_target", t_sync,
                     f"{h_sync[-1]['acc']:.3f}"))
    rows.append(emit("straggler.semi.t_to_target", t_semi,
                     f"{h_semi[-1]['acc']:.3f}"))
    speedup = t_sync / t_semi if t_semi > 0 else float("nan")
    rows.append(emit("straggler.semi_vs_sync_speedup", 0, f"{speedup:.2f}x"))
    rows.append(emit("straggler.semi.max_staleness", 0,
                     eng.staleness_hist.max))
    return rows


if __name__ == "__main__":
    main()
