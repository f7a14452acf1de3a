#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):

1. build    — compile the port's CUDA kernels with nvcc for sm_90a;
2. kernels  — hold each kernel against its plain PyTorch version on the
              card, bit for bit in fp32 and bf16, at the main path's leaf
              shapes (the paper CNN at width 32, its 16 leaves stacked over
              K=8 clients) and at ResNet-18's largest leaf; the weighted
              reduce also at K=96 bf16 against an fp64 oracle (1 bf16 ulp);
              then time each kernel, its plain version and, where one
              PyTorch call computes the same function, that call;
3. main     — the paper CNN at width 32 on 32x32x3 images at CIFAR-10
              cardinality (50000/10000), sort-and-partition s=2 over 100
              clients, FedConfig defaults (|S|=8, H=8, nesterov) but eta 0.01,
              batch 64:
              5 FedADC rounds, then one heavy-ball and one FedAvg round,
              counting every kernel launch against the count the rounds
              should make; then one profiled round; then the card (TF32
              off) against the CPU from the same parameters and batches:
              two one-step rounds must give the same update within 1e-4
              relative, one main-path round within 5e-2;
4. resnet   — one FedADC round of ResNet-18 with 100 classes (|S|=8, H=2)
              and the kernels timed over its 76 leaves;
5. quickstart — the port's quickstart (40 rounds of FedAvg and FedADC).

Every time is measured here, on the card named in the output.  Bounds use
the H100 SXM data sheet: 3.35 TB/s of HBM and 67 TFLOP/s of fp32 outside
the tensor cores.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TPU_KERNEL = {
    "fused_axpy": "src/repro/kernels/fedadc_update.py:62",
    "local_update": "src/repro/kernels/fedadc_update.py:66",
    "server_update": "src/repro/kernels/fedadc_update.py:71",
    "weighted_reduce": "src/repro/kernels/weighted_reduce.py:45",
}
SOURCE = "src/repro_torch/csrc/fedadc_kernels.cu"
K = 8
ETA = 0.01


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, iters=30, warmup=3):
    """Mean device time of fn() over `iters` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(kernel, sizes, k=K):
    """(bound_ms, bound_by) for one sweep of `kernel` over leaves of the
    given element counts, fp32: each input read once, each output written
    once, against the HBM rate and the fp32 rate."""
    n = sum(sizes)
    nbytes, flops = {
        "fused_axpy": (3 * 4 * k * n, 2 * k * n),
        "local_update": (4 * 4 * k * n, 3 * k * n),
        "server_update": (5 * 4 * n, 4 * n),
        "weighted_reduce": (4 * (k + 1) * n, 2 * k * n),
    }[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sweeps(torch, FU, WR, ref, shapes, dtype, gen):
    """Per kernel: (kernel sweep, plain sweep, library sweep or None) over
    leaves of `shapes`, on random operands in `dtype`."""
    dev = "cuda"

    def rnd(*shape, dt=dtype):
        return torch.randn(shape, generator=gen).to(dev, dt)
    xs = [rnd(K, *s) for s in shapes]
    ys = [rnd(K, *s) for s in shapes]
    zs = [rnd(K, *s) for s in shapes]
    th = [rnd(*s) for s in shapes]
    ms = [rnd(*s, dt=torch.float32) for s in shapes]
    ds = [rnd(*s, dt=torch.float32) for s in shapes]
    w = torch.rand(K, generator=gen).to(dev)
    a, eta, gamma, ae = -0.05, 0.05, 0.2, 0.05
    return {
        "fused_axpy": (
            lambda: [FU.fused_axpy(x, y, a) for x, y in zip(xs, ys)],
            lambda: [ref.fused_axpy(x, y, a) for x, y in zip(xs, ys)],
            lambda: [torch.add(x, y, alpha=a) for x, y in zip(xs, ys)]),
        "local_update": (
            lambda: [FU.local_update(x, y, z, eta)
                     for x, y, z in zip(xs, ys, zs)],
            lambda: [ref.fedadc_local_update(x, y, z, eta)
                     for x, y, z in zip(xs, ys, zs)],
            None),
        "server_update": (
            lambda: [FU.server_update(t, m, d, gamma, ae)
                     for t, m, d in zip(th, ms, ds)],
            lambda: [ref.fedadc_server_update(t, m, d, gamma, ae)
                     for t, m, d in zip(th, ms, ds)],
            None),
        "weighted_reduce": (
            lambda: [WR.weighted_reduce(x, w) for x in xs],
            lambda: [ref.weighted_delta_reduce(x, w) for x in xs],
            lambda: [torch.tensordot(w, x, 1) for x in xs]),
    }


def max_err(got, want):
    flat = []
    for g, p in zip(got, want):
        pairs = zip(g, p) if isinstance(g, tuple) else [(g, p)]
        flat += [(a.float() - b.float()).abs().max().item() for a, b in pairs]
    return max(flat)


def leaf_shapes(params):
    from repro_torch.core.tree import leaves
    return [tuple(t.shape) for t in leaves(params)]


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import quickstart
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import tree as T
    from repro_torch.data.partition import (dirichlet_partition,
                                            sort_and_partition)
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.simulator import FederatedSimulator, SimConfig
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import fedadc_update as FU
    from repro_torch.kernels import weighted_reduce as WR
    from repro_torch.models.vision import cnn_init

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    for rec in build.build_all():
        log(f"build: {Path(rec['source']).name} built={rec['built']} "
            f"in {rec['seconds']:.1f}s")
    log(f"build: {time.perf_counter() - t0:.1f}s")

    # -- 2. kernels against plain, then timed ---------------------------------
    gen = torch.Generator().manual_seed(0)
    cnn_shapes = leaf_shapes(cnn_init(0, width=32, image_size=32,
                                      device="cpu"))
    resnet_leaf = [(512, 512, 3, 3)]
    errs = {name: 0.0 for name in ops.KERNELS}
    for shapes in (cnn_shapes, resnet_leaf):
        for dtype in (torch.float32, torch.bfloat16):
            for name, (kern, plain, _) in sweeps(torch, FU, WR, ref, shapes,
                                                 dtype, gen).items():
                e = max_err(kern(), plain())
                torch.cuda.synchronize()
                log(f"check {name} {dtype} {len(shapes)} leaves: "
                    f"max |kernel - plain| = {e}")
                if e != 0.0:
                    raise AssertionError(f"{name} {dtype}: kernel differs "
                                         f"from its plain version by {e}")
                errs[name] = max(errs[name], e)
    d64 = 1.0 + 0.05 * torch.randn((96, 2359296), generator=gen,
                                   dtype=torch.float64)
    d_bf16 = d64.to(torch.bfloat16)
    w96 = torch.rand(96, generator=gen)
    oracle = torch.tensordot(w96.double(), d_bf16.double(), 1)
    got = WR.weighted_reduce(d_bf16.cuda(), w96.cuda()).double().cpu()
    worst = ((got - oracle).abs() / oracle.abs()).max().item()
    log(f"check weighted_reduce bf16 K=96 vs fp64: max rel err {worst} "
        f"(bar 2**-8 = {2.0 ** -8})")
    if worst > 2.0 ** -8:
        raise AssertionError("weighted_reduce K=96 bf16 misses 1 bf16 ulp")
    del d64, d_bf16, oracle

    cnn_sizes = [int(torch.Size(s).numel()) for s in cnn_shapes]
    timed = {}
    for name, (kern, plain, lib) in sweeps(torch, FU, WR, ref, cnn_shapes,
                                           torch.float32, gen).items():
        b_ms, b_by = bound(name, cnn_sizes)
        timed[name] = {"ms": cuda_ms(torch, kern),
                       "plain_ms": cuda_ms(torch, plain),
                       "library_ms": cuda_ms(torch, lib) if lib else None,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"time {name} over the CNN's {len(cnn_sizes)} leaves (fp32"
            f"{', K=8' if name != 'server_update' else ''}): "
            f"{json.dumps(timed[name])}")
    for name, (kern, plain, lib) in sweeps(torch, FU, WR, ref, resnet_leaf,
                                           torch.float32, gen).items():
        b_ms, b_by = bound(name, [2359296])
        log(f"time {name} on ResNet-18's largest leaf (2359296): "
            f"ms={cuda_ms(torch, kern)} plain_ms={cuda_ms(torch, plain)} "
            f"library_ms={cuda_ms(torch, lib) if lib else None} "
            f"bound_ms={b_ms} ({b_by})")

    # -- 3. the main path: paper CNN at width 32 ----------------------------
    log(f"main: TF32 cudnn={torch.backends.cudnn.allow_tf32} "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} (library defaults)")
    t0 = time.perf_counter()
    x, y, xt, yt = make_image_dataset(50000, 10000, 10, image_size=32)
    parts = sort_and_partition(y, n_clients=100, s=2)
    log(f"main: data {x.shape} in {time.perf_counter() - t0:.1f}s")
    sim_cfg = SimConfig(model="cnn", n_classes=10, rounds=5, eval_every=5,
                        cnn_width=32)
    # FedConfig defaults but eta: at its default 0.05 this CNN's first round
    # diverges to NaN, in the reference as in the port
    fed = FedConfig(eta=ETA)
    n_leaves = len(cnn_shapes)
    H = fed.local_steps
    expected = {"fused_axpy": 5 * 2 * H * n_leaves + H * n_leaves,
                "local_update": H * n_leaves,
                "server_update": 5 * n_leaves + n_leaves,
                "weighted_reduce": 5 * n_leaves + 2 * n_leaves}
    ops.reset_launch_counts()
    sim = FederatedSimulator(fed, sim_cfg, x, y, xt, yt, parts)
    round_s = []
    for _ in range(5):
        inputs = sim.next_round_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = sim.run_round(*inputs)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        if not torch.isfinite(loss):
            raise AssertionError(f"main: non-finite loss {loss}")
    acc = sim.evaluate()
    log(f"main: fedadc nesterov round seconds {round_s}, last loss "
        f"{float(loss)}, accuracy after 5 rounds {acc}")
    for variant, strategy in (("heavyball", "fedadc"),
                              ("nesterov", "fedavg")):
        s = FederatedSimulator(FedConfig(strategy=strategy, variant=variant,
                                         eta=ETA),
                               SimConfig(model="cnn", rounds=1, eval_every=1,
                                         cnn_width=32),
                               x, y, xt, yt, parts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = s.run()
        torch.cuda.synchronize()
        log(f"main: {strategy} {variant} one round + eval "
            f"{time.perf_counter() - t0:.3f}s -> {hist[-1]}")
        if not (torch.isfinite(torch.tensor(hist[-1]["loss"]))
                and 0.0 <= hist[-1]["acc"] <= 1.0):
            raise AssertionError(f"main: bad result {hist[-1]}")
    launches = ops.launch_counts()
    log(f"main: launches {launches}, expected {expected}")
    if launches != expected or min(launches.values()) == 0:
        raise AssertionError("main: kernel launches differ from the count "
                             "the rounds should make")

    # one profiled FedADC round: device time by kernel and the idle share
    inputs = sim.next_round_inputs()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        sim.run_round(*inputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (the kernels), so no time counts twice
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    steady_ms = sorted(round_s[1:])[len(round_s[1:]) // 2] * 1e3
    if busy_ms > 0:
        log(f"profile: kernels busy {busy_ms:.3f} ms in {len(rows)} kinds; "
            f"profiled round wall {wall_ms:.3f} ms; unprofiled median round "
            f"{steady_ms:.3f} ms; idle share {1 - busy_ms / steady_ms:.3f} "
            f"of the unprofiled round")
        for key, ms, count in rows[:12]:
            log(f"profile:   {ms:9.3f} ms  x{count:<5} {key[:90]}")
    else:
        log("profile: the profiler recorded no device time (not measured)")

    # the card (TF32 off) against the CPU from the same parameters and
    # batches, compared on the update Δθ = θ − θ_0 over the whole model:
    # (a) two one-step rounds, where each step is one gradient and cuDNN's
    #     and oneDNN's fp32 convolutions differ only in summation order
    #     (~1e-5 relative): bar 1e-4;
    # (b) the main path's round, H=8: ReLU and max-pool switches amplify
    #     those differences over the steps, while a wrong leaf, sign or
    #     momentum term moves the update by O(1): bar 5e-2
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log("compare: TF32 off for cudnn and matmul on the card")
    params0 = cnn_init(7, width=32, image_size=32, device="cpu")
    for what, steps, rounds, bar in (("two one-step rounds", 1, 2, 1e-4),
                                      ("one main-path round", H, 1, 5e-2)):
        ends = []
        for device in ("cuda", "cpu"):
            s = FederatedSimulator(
                FedConfig(eta=ETA, local_steps=steps),
                SimConfig(cnn_width=32, seed=7), x, y, xt, yt, parts,
                params=T.tree_map(lambda t: t.clone(), params0),
                device=device)
            t0 = time.perf_counter()
            for _ in range(rounds):
                loss = s.run_round(*s.next_round_inputs())
            ends.append(T.tree_map(lambda t: t.cpu(), s.params))
            log(f"compare: {what} on {device} in "
                f"{time.perf_counter() - t0:.1f}s, loss {float(loss)}")
        num = sum(((a - b) ** 2).sum()
                  for a, b in zip(T.leaves(ends[0]), T.leaves(ends[1])))
        den = sum(((b - p) ** 2).sum()
                  for b, p in zip(T.leaves(ends[1]), T.leaves(params0)))
        err = (num / den).sqrt().item()
        log(f"compare: {what}: |dθ card - dθ cpu| / |dθ cpu| = {err} "
            f"(bar {bar})")
        if not err <= bar:
            raise AssertionError(f"card and CPU disagree on {what}")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32

    # -- 4. ResNet-18 at CIFAR-100 shape ------------------------------------
    x100, y100, xt100, yt100 = make_image_dataset(50000, 10000, 100,
                                                  image_size=32)
    parts100 = dirichlet_partition(y100, n_clients=100, alpha=0.3)
    s = FederatedSimulator(FedConfig(local_steps=2, eta=ETA),
                           SimConfig(model="resnet18", n_classes=100,
                                     rounds=1, eval_every=1),
                           x100, y100, xt100, yt100, parts100)
    for r in range(2):
        inputs = s.next_round_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = s.run_round(*inputs)
        torch.cuda.synchronize()
        log(f"resnet18: round {r + 1} {time.perf_counter() - t0:.3f}s, "
            f"loss {float(loss)}")
        if not torch.isfinite(loss):
            raise AssertionError("resnet18: non-finite loss")
    log(f"resnet18: accuracy {s.evaluate()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    rshapes = leaf_shapes(s.params)
    rsizes = [int(torch.Size(sh).numel()) for sh in rshapes]
    log(f"resnet18: {len(rshapes)} leaves, {sum(rsizes)} parameters")
    for name, (kern, plain, lib) in sweeps(torch, FU, WR, ref, rshapes,
                                           torch.float32, gen).items():
        b_ms, b_by = bound(name, rsizes)
        log(f"time {name} over ResNet-18's {len(rshapes)} leaves: "
            f"ms={cuda_ms(torch, kern, iters=10)} "
            f"plain_ms={cuda_ms(torch, plain, iters=3, warmup=1)} "
            f"library_ms={cuda_ms(torch, lib, iters=10) if lib else None} "
            f"bound_ms={b_ms} ({b_by})")

    # -- 5. the port's quickstart -------------------------------------------
    t0 = time.perf_counter()
    hist = quickstart.run(device="cuda")
    gap = hist["fedadc"][-1]["acc"] - hist["fedavg"][-1]["acc"]
    log(f"quickstart: {time.perf_counter() - t0:.1f}s, "
        f"FedADC - FedAvg = {gap:+.3f}")

    log(f"total: {time.perf_counter() - t_start:.1f}s")
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": TPU_KERNEL[name], "launches": launches[name],
         "max_abs_err": errs[name], **timed[name]}
        for name in ops.KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
