"""Fig. 1 (a-c): FedADC vs FedAvg vs SlowMo under sort-and-partition
non-iid data, s ∈ {2,3,4}.  Paper claim: FedADC ≥ SlowMo > FedAvg, gap
widening as s shrinks."""
from repro_torch.benchmarks.common import dataset, emit, partitions, run_fl

ROUNDS = 60


def main(rows=None, device=None):
    data = dataset()
    rows = rows if rows is not None else []
    for s in (2, 3, 4):
        parts = partitions(data[1], 20, "sort", s)
        accs = {}
        for strat, eta in (("fedavg", 0.05), ("slowmo", 0.01),
                           ("fedadc", 0.01)):
            r = run_fl(strat, parts, data, rounds=ROUNDS, eta=eta,
                       device=device)
            accs[strat] = r["acc"]
            rows.append(emit(f"fig1.s{s}.{strat}", r["us_per_round"],
                             f"{r['acc']:.3f}"))
        gap = accs["fedadc"] - accs["fedavg"]
        rows.append(emit(f"fig1.s{s}.fedadc_minus_fedavg", 0, f"{gap:+.3f}"))
    return rows


if __name__ == "__main__":
    main()
