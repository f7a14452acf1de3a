"""Fig. 5/6: large-scale low-participation regime — FedADC+ vs FedDyn with
many clients and small participation ratio (paper: 500-1000 clients,
C=0.01-0.02; here 50 clients, C=0.06)."""
from repro_torch.benchmarks.common import dataset, emit, partitions, run_fl

ROUNDS = 50


def main(rows=None, device=None):
    data = dataset()
    rows = rows if rows is not None else []
    parts = partitions(data[1], 50, "dir", 0.3)
    # the paper's stress regime: MANY local epochs at low participation is
    # where FedDyn's dynamic regularisation destabilises (Fig. 5b)
    for name, strat, kw in (
            ("fedadc+", "fedadc", dict(eta=0.01, distill=True)),
            ("feddyn", "feddyn", dict(eta=0.05)),
            ("fedavg", "fedavg", dict(eta=0.05))):
        r = run_fl(strat, parts, data, rounds=ROUNDS, n_clients=50,
                   clients_per_round=3, local_steps=20, device=device, **kw)
        rows.append(emit(f"fig5.C0.06.{name}", r["us_per_round"],
                         f"{r['acc']:.3f}"))
    return rows


if __name__ == "__main__":
    main()
