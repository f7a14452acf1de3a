"""Table I: FedADC / FedADC+ vs SOTA FL baselines on two regimes
(sort-and-partition s=2, and Dirichlet α=0.3), C=0.2.  Miniaturised: 20
clients, 50 rounds, synthetic class-Gaussian images."""
from repro_torch.benchmarks.common import dataset, emit, partitions, run_fl

ROUNDS = 50
METHODS = [
    ("fedavg", dict(eta=0.05)),
    ("moon", dict(eta=0.05)),
    ("fedgkd", dict(eta=0.05)),
    ("fedntd", dict(eta=0.05)),
    ("feddyn", dict(eta=0.05, extra_fed={"feddyn_alpha": 0.01})),
    ("fedprox", dict(eta=0.05, extra_fed={"mu_prox": 0.01})),
    ("scaffold", dict(eta=0.05)),
    ("fedadc", dict(eta=0.01)),
    ("fedadc+", dict(eta=0.01)),
    ("fedrs", dict(eta=0.05)),          # sort-and-partition only (paper)
]


def main(rows=None, device=None):
    data = dataset()
    rows = rows if rows is not None else []
    results = {}
    for setting, kind, param in (("s2", "sort", 2), ("dir0.3", "dir", 0.3)):
        parts = partitions(data[1], 20, kind, param)
        for name, kw in METHODS:
            if name == "fedrs" and kind != "sort":
                continue                 # paper: FedRS needs missing classes
            strat = "fedadc" if name == "fedadc+" else name
            distill = name == "fedadc+"
            r = run_fl(strat, parts, data, rounds=ROUNDS, distill=distill,
                       **{k: v for k, v in kw.items() if k != "extra_fed"},
                       extra_fed=kw.get("extra_fed"), device=device)
            results[(setting, name)] = r["acc"]
            rows.append(emit(f"table1.{setting}.{name}", r["us_per_round"],
                             f"{r['acc']:.3f}"))
        ours = max(results[(setting, "fedadc")],
                   results[(setting, "fedadc+")])
        best_baseline = max(v for (st, n), v in results.items()
                            if st == setting and not n.startswith("fedadc"))
        rows.append(emit(f"table1.{setting}.ours_minus_best_baseline", 0,
                         f"{ours - best_baseline:+.3f}"))
    return rows


if __name__ == "__main__":
    main()
