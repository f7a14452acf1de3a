"""Sec. IV-E: data-aware client selection — class-coverage-constrained
sampling vs uniform random at low participation (paper: +2.1% on CIFAR-10
s=2, C=0.1)."""
from repro_torch.benchmarks.common import dataset, emit, partitions, run_fl

ROUNDS = 50


def main(rows=None, device=None):
    data = dataset()
    rows = rows if rows is not None else []
    parts = partitions(data[1], 20, "sort", 2)
    accs = {}
    for selector in ("random", "class_coverage"):
        r = run_fl("fedadc", parts, data, rounds=ROUNDS, eta=0.01,
                   clients_per_round=3, selector=selector, device=device)
        accs[selector] = r["acc"]
        rows.append(emit(f"clustering.{selector}", r["us_per_round"],
                         f"{r['acc']:.3f}"))
    rows.append(emit("clustering.coverage_minus_random", 0,
                     f"{accs['class_coverage'] - accs['random']:+.3f}"))
    return rows


if __name__ == "__main__":
    main()
