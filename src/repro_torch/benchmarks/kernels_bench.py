"""Kernel micro-benchmarks of the port (counterpart of
``benchmarks/kernels_bench.py``): µs per call of every kernel of
``kernels.ops.KERNELS`` plus the DERIVED analytic bytes moved / FLOPs per
call, the hardware-independent terms the roofline uses.

On the card each row times the kernel with CUDA events over ``CARD_ITERS``
calls after ``WARMUP`` (a call is host-bound where the kernel is short: the
Python and ctypes pass around a launch, ``PERF.md`` §6); with ``--device
cpu`` the same wrappers take the kernels' plain versions, timed over
``ITERS`` calls, and the rows say ``route=plain-cpu``: those µs gauge
dispatch, not the card.  Shapes are the reference's where it has a row (1M-
element update and reduce sweeps, flash 1×4×512×64, the SSD at 512 with
chunk 128, KD 256×1000); the kernels it has no row for take the pod
engine's shapes: ``fused_axpy``, ``threshold_select`` and ``qsgd`` sweep
``lm_round``'s model's leaf table (one client row, bf16, as the pod uplink
gives them), ``sparse_reduce`` adds that table's top-10% wires of 4
clients, and ``kd_loss_bwd`` is ``kd_loss``'s gradient at its shape.

The ``sparse_aggregate`` section sweeps ``topk_frac`` and writes
``BENCH_kernels_torch.json`` with ``BENCH_kernels.json``'s fields: the
analytic aggregate-FLOPs cells are deterministic (regression-checked by
``check_regression.py`` and ``--require``-pinned); the measured µs and
speedups ride wall-clock-named keys the gate skips.  Dense-decode scatters
every client's wire into a dense leaf and reduces at K·d cost
(``ops.sparse_scatter_leaf`` + ``ops.weighted_delta_reduce``), the
sparse-native path adds the wire at K·k (``ops.sparse_weighted_delta_reduce``:
the ``sparse_reduce`` kernel on the card).

The file goes to ``results/`` by default, so that a run from the repo's
root leaves the committed ``BENCH_kernels_torch.json`` (a CPU run, the
regression baseline) as it is.

Run:  PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench
          [--device cpu] [--out results/BENCH_kernels_torch.json]
"""
import argparse
import json
import math
import os
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import block_until_ready, emit
from repro_torch.core import tree as T
from repro_torch.device import resolve_device
from repro_torch.kernels import kd_loss as KD
from repro_torch.kernels import ops

TOPK_FRACS = (0.01, 0.05, 0.1, 0.25)
ITERS = 5                               # calls timed on the CPU
CARD_ITERS, WARMUP = 30, 3              # on the card
# the reference's shapes (``benchmarks/kernels_bench.py``)
N_SWEEP = 1 << 20
K_REDUCE = 8
FLASH = (1, 4, 512, 64)                 # B, H, L, D
SSD = (1, 512, 4, 64, 64, 128)          # b, L, H, P, N, chunk
KD_SHAPE = (256, 1000)                  # rows, classes
SPARSE = {"K": 16, "d": 1 << 20}        # the sparse_aggregate section
POD_CLIENTS = 4                         # sparse_reduce's clients


def _time(fn, device):
    """µs per call of ``fn`` after a warm-up: CUDA events on the card, the
    host clock after a barrier on the CPU."""
    if device.type == "cuda":
        for _ in range(WARMUP):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CARD_ITERS):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / CARD_ITERS * 1e3
    fn()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fn()
    block_until_ready(device)
    return (time.perf_counter() - t0) / ITERS * 1e6


def _route(device):
    return "kernel" if device.type == "cuda" else "plain-cpu"


def pod_leaves(device, dtype=torch.bfloat16):
    """``lm_round``'s model's parameters as one client's row: every leaf
    with a leading axis of 1, in ``dtype``."""
    from repro_torch.benchmarks import lm_round
    from repro_torch.models.registry import get_model
    cfg = lm_round.model_config()
    params = get_model(cfg).init(0, cfg, device=device)
    return T.tree_map(lambda x: x.to(dtype).unsqueeze(0), params)


def sparse_aggregate_section(rows, device, K=None, d=None, seed=0):
    """Server-aggregate cost vs top-k fraction: K clients' (values,
    indices) wires summed into one dense (d,) leaf.  2·K·d multiply-adds
    for dense-decode, 2·K·k for sparse-native, so the work ratio is 1/frac
    and ``ge_4x_at_0p1`` (the gated bool) asserts the sparse aggregate
    does ≥4× less aggregation work at topk_frac=0.1."""
    K = SPARSE["K"] if K is None else K
    d = SPARSE["d"] if d is None else d
    rng = np.random.RandomState(seed)
    w = torch.as_tensor(rng.uniform(0.2, 1.0, K).astype(np.float32),
                        device=device)

    def dense_decode_agg(values, indices):
        dense = ops.sparse_scatter_leaf(values, indices, (d,), torch.float32)
        return ops.weighted_delta_reduce(dense, w)

    def sparse_agg(values, indices):
        return ops.sparse_weighted_delta_reduce(values, indices, w, (d,),
                                                torch.float32)

    cells = []
    for frac in TOPK_FRACS:
        k = int(np.ceil(frac * d))
        values = torch.as_tensor(rng.randn(K, k).astype(np.float32),
                                 device=device)
        indices = torch.as_tensor(
            np.stack([rng.choice(d, size=k, replace=False)
                      for _ in range(K)]).astype(np.int32), device=device)
        us_dense = _time(lambda: dense_decode_agg(values, indices), device)
        us_sparse = _time(lambda: sparse_agg(values, indices), device)
        cell = {
            "topk_frac": frac,
            "k": k,
            "flops_dense": 2 * K * d,
            "flops_sparse": 2 * K * k,
            "flops_ratio": round(2 * K * d / (2 * K * k), 2),
            "us_dense": round(us_dense, 1),
            "us_sparse": round(us_sparse, 1),
            "speedup": round(us_dense / us_sparse, 2),
        }
        cells.append(cell)
        rows.append(emit(f"kernel.sparse_aggregate.K{K}.frac{frac}",
                         us_sparse,
                         f"speedup={cell['speedup']};"
                         f"flops_ratio={cell['flops_ratio']};"
                         f"route={_route(device)}"))
    at_0p1 = next(c for c in cells if c["topk_frac"] == 0.1)
    return {
        "K": K,
        "d": d,
        "cells": cells,
        "flops_scale_with_k": bool(
            all(c["flops_sparse"] == 2 * K * c["k"]
                and c["flops_dense"] == 2 * K * d for c in cells)
            and all(a["flops_sparse"] < b["flops_sparse"]
                    for a, b in zip(cells, cells[1:]))),
        "ge_4x_at_0p1": bool(at_0p1["flops_ratio"] >= 4.0),
        "speedup_at_0p1": at_0p1["speedup"],
    }


def update_rows(rows, device):
    """The reference's three rows, then the pod sweeps' four."""
    route = _route(device)
    n = N_SWEEP
    ones = torch.ones((n,), dtype=torch.float32, device=device)
    theta, g, m = {"p": ones}, {"p": ones * 0.1}, {"p": ones * 0.01}
    us = _time(lambda: ops.fedadc_local_update_tree(theta, g, m, 0.05),
               device)
    rows.append(emit("kernel.fedadc_local_update.1M", us,
                     f"bytes_moved={4*n*4};vs_unfused={6*n*4};"
                     f"route={route}"))
    us = _time(lambda: ops.fedadc_server_update_tree(theta, m, g, 0.1, 0.05),
               device)
    rows.append(emit("kernel.fedadc_server_update.1M", us,
                     f"bytes_moved={5*n*4};vs_unfused={8*n*4};"
                     f"route={route}"))
    K = K_REDUCE
    stacked = {"p": torch.ones((K, n), dtype=torch.float32, device=device)}
    w = torch.full((K,), 1.0 / K, device=device)
    us = _time(lambda: ops.weighted_delta_reduce_tree(stacked, w), device)
    rows.append(emit(f"kernel.weighted_delta_reduce.K{K}.1M", us,
                     f"bytes_moved={(K+1)*n*4};vs_unfused={(2*K+1)*n*4};"
                     f"route={route}"))

    # the pod engine's sweeps over lm_round's model, one bf16 client row
    gen = torch.Generator(device=device).manual_seed(0)
    v = T.tree_map(lambda x: torch.randn(x.shape, generator=gen,
                                         device=device).to(x.dtype),
                   pod_leaves(device))
    leaves = T.leaves(v)
    n_pod = sum(x.numel() for x in leaves)
    e = leaves[0].element_size()
    us = _time(lambda: ops.fused_axpy_tree(v, v, -0.01), device)
    rows.append(emit(f"kernel.fused_axpy.pod{n_pod}", us,
                     f"bytes_moved={3*n_pod*e};vs_unfused={5*n_pod*e};"
                     f"route={route}"))
    # each row's τ is its top-10% threshold, as the pod uplink's
    taus = T.tree_map(lambda x: torch.topk(
        x.float().abs().reshape(1, -1), max(1, math.ceil(0.1 * x.numel())),
        dim=1).values[:, -1], v)
    us = _time(lambda: ops.topk_compress_tree(v, taus), device)
    rows.append(emit(f"kernel.threshold_select.pod{n_pod}", us,
                     f"bytes_moved={3*n_pod*e};route={route}"))
    u = T.tree_map(lambda x: torch.rand(x.shape, generator=gen,
                                        device=device).to(x.dtype), v)
    us = _time(lambda: ops.qsgd_compress_tree(v, u, 15), device)
    rows.append(emit(f"kernel.qsgd.pod{n_pod}", us,
                     f"bytes_moved={4*n_pod*e};route={route}"))

    # sparse_reduce: POD_CLIENTS clients' top-10% wires of every leaf
    Kc = POD_CLIENTS
    wc = torch.full((Kc,), 1.0 / Kc, device=device)
    vals, idxs, likes = {}, {}, {}
    wire = 0
    for i, x in enumerate(leaves):
        k = max(1, math.ceil(0.1 * x.numel()))
        vals[i] = torch.randn((Kc, k), generator=gen, device=device)
        idxs[i] = torch.stack([torch.randperm(x.numel(), generator=gen,
                                              device=device)[:k]
                               for _ in range(Kc)]).to(torch.int32)
        likes[i] = torch.empty(x.shape[1:], dtype=torch.float32,
                               device=device)
        wire += Kc * k
    us = _time(lambda: ops.sparse_weighted_delta_reduce_tree(
        vals, idxs, wc, likes), device)
    rows.append(emit(f"kernel.sparse_reduce.K{Kc}.pod{n_pod}", us,
                     f"bytes_moved={wire*8 + n_pod*4};flops={2*wire};"
                     f"route={route}"))


def lm_rows(rows, device):
    """Flash attention, the SSD scan and the KD pair at the reference's
    shapes."""
    route = _route(device)
    gen = torch.Generator(device=device).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)
    B, H, L, D = FLASH
    q, k, v = randn(B, L, H, D), randn(B, L, H, D), randn(B, L, H, D)
    us = _time(lambda: ops.flash_attention(q, k, v), device)
    rows.append(emit(f"kernel.flash_attention.{L}", us,
                     f"flops={4*B*H*L*L*D};route={route}"))

    b, Lq, Hh, P, N, chunk = SSD
    x = randn(b, Lq, Hh, P)
    dt = torch.nn.functional.softplus(randn(b, Lq, Hh))
    A_log = torch.zeros((Hh,), device=device)
    Bm, Cm = randn(b, Lq, Hh, N), randn(b, Lq, Hh, N)
    Dv = torch.ones((Hh,), device=device)
    us = _time(lambda: ops.ssd_scan(x, dt, A_log, Bm, Cm, Dv, chunk=chunk),
               device)
    nc = Lq // chunk
    intra = b * Hh * nc * (2 * chunk * chunk * N + 2 * chunk * chunk * P)
    rows.append(emit(f"kernel.ssd_scan.{Lq}", us,
                     f"flops~={intra};route={route}"))

    Bb, C = KD_SHAPE
    s, t = randn(Bb, C), randn(Bb, C)
    y = torch.randint(0, C, (Bb,), generator=gen, device=device)
    rho = torch.rand((C,), generator=gen, device=device)
    us = _time(lambda: ops.kd_loss(s, t, y, rho, 0.35, 1.0), device)
    rows.append(emit(f"kernel.kd_loss.{Bb}x{C}", us,
                     f"bytes_fused={2*Bb*C*4};vs_unfused~={5*2*Bb*C*4};"
                     f"route={route}"))
    rho2 = rho.reshape(1, -1)
    stats = KD.KDLoss.apply(s, t, y, rho2, 0.35, 1.0)[3]
    g = torch.ones((Bb,), device=device)
    us = _time(lambda: KD.KDLossBackward.apply(s, t, y, rho2, stats, g,
                                               0.35, 1.0), device)
    rows.append(emit(f"kernel.kd_loss_bwd.{Bb}x{C}", us,
                     f"bytes_fused={3*Bb*C*4};route={route}"))


OUT_JSON = os.path.join("results", "BENCH_kernels_torch.json")


def main(rows=None, device=None, out_json=OUT_JSON):
    rows = rows if rows is not None else []
    device = resolve_device(device)
    with torch.no_grad():
        update_rows(rows, device)
        lm_rows(rows, device)
        report = {"sparse_aggregate": sparse_aggregate_section(rows, device)}
    os.makedirs(os.path.dirname(out_json) or ".", exist_ok=True)
    with open(out_json, "w") as f:
        json.dump(report, f, indent=2)
    print(f"# wrote {out_json}")
    assert report["sparse_aggregate"]["ge_4x_at_0p1"], (
        "sparse-native aggregate no longer does ≥4× less aggregation "
        "work than dense-decode at topk_frac=0.1")
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=OUT_JSON)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args()
    main(out_json=args.out, device=args.device)
