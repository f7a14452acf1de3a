"""Ablations on the paper's momentum-embedding knob (Sec. II: "by playing
with β_local it is possible to seek different strategies"; β_local =
β_global = β is the paper's default to keep the hyper-parameter count at
FedAvg's level).

(a) β sweep (the paper's grid) at s=2;
(b) β_local ∈ {0, β/2, β} with β_global = β fixed — β_local = 0 recovers
    pure SlowMo (momentum only at the server, no drift control), so the
    gap between β_local = 0 and β_local = β isolates the *drift-control*
    contribution of the momentum embedding from the *acceleration* one.
"""
from repro_torch.benchmarks.common import dataset, emit, partitions, run_fl

ROUNDS = 50


def main(rows=None, device=None):
    data = dataset()
    rows = rows if rows is not None else []
    parts = partitions(data[1], 20, "sort", 2)

    for beta in (0.6, 0.7, 0.8, 0.9):
        r = run_fl("fedadc", parts, data, rounds=ROUNDS, eta=0.01, beta=beta,
                   device=device)
        rows.append(emit(f"ablation.beta{beta}", r["us_per_round"],
                         f"{r['acc']:.3f}"))

    accs = {}
    for frac, name in ((0.0, "0"), (0.5, "half"), (1.0, "full")):
        r = run_fl("fedadc", parts, data, rounds=ROUNDS, eta=0.01,
                   beta=0.7, extra_fed={"beta_local": 0.7 * frac,
                                        "beta_global": 0.7}, device=device)
        accs[name] = r["acc"]
        rows.append(emit(f"ablation.beta_local_{name}", r["us_per_round"],
                         f"{r['acc']:.3f}"))
    rows.append(emit("ablation.drift_control_gain", 0,
                     f"{accs['full'] - accs['0']:+.3f} "
                     f"(beta_local=beta vs beta_local=0≡SlowMo)"))
    return rows


if __name__ == "__main__":
    main()
