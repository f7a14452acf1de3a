"""Fig. 2: FedADC convergence for s = 2,3,4 — robustness of the FINAL
accuracy to data skew (paper: similar final level, slower convergence for
smaller s), plus nesterov (red) vs heavy-ball (blue) variants."""
from repro_torch.benchmarks.common import dataset, emit, partitions, run_fl

ROUNDS = 60


def main(rows=None, device=None):
    data = dataset()
    rows = rows if rows is not None else []
    finals = {}
    for s in (2, 3, 4):
        parts = partitions(data[1], 20, "sort", s)
        r = run_fl("fedadc", parts, data, rounds=ROUNDS, eta=0.01,
                   eval_every=ROUNDS // 3, device=device)
        finals[s] = r["acc"]
        mid = r["hist"][0]["acc"]
        rows.append(emit(f"fig2.s{s}.final", r["us_per_round"],
                         f"{r['acc']:.3f}"))
        rows.append(emit(f"fig2.s{s}.early", 0, f"{mid:.3f}"))
    spread = max(finals.values()) - min(finals.values())
    rows.append(emit("fig2.final_acc_spread", 0, f"{spread:.3f}"))
    # red vs blue variants at s=2
    parts = partitions(data[1], 20, "sort", 2)
    for variant in ("nesterov", "heavyball"):
        r = run_fl("fedadc", parts, data, rounds=ROUNDS, eta=0.01,
                   extra_fed={"variant": variant}, device=device)
        rows.append(emit(f"fig2.s2.{variant}", r["us_per_round"],
                         f"{r['acc']:.3f}"))
    return rows


if __name__ == "__main__":
    main()
