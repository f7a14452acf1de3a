#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

``python3 chip_smoke.py --kernel-times [--src OTHER/src]`` only builds the
port of this (or another) checkout and times its SSD scan, flash attention
at the prefill shape, QSGD sweep, sparse reduce of the CNN, local and
server update sweeps, threshold-select sweep and KD pair
(``kernel_times``), one JSON line, so that two checkouts can be timed in
turns on one card.

``python3 chip_smoke.py --kernel-shapes`` only builds and runs the checks
and times of the shapes past the kernels' single-tile routes
(``kernel_shapes_main``: the wide KD, flash and SSD shapes and
``shapes_phase``), one JSON line of the times.

Phases (any failure ends the run with a non-zero exit and no result line):

1. build    — compile the port's CUDA kernels with nvcc for sm_90a, and log
              each kernel's registers and spills (ptxas -v);
2. kernels  — hold each of the seven update and wire kernels against its
              plain PyTorch version on the card, bit for bit in fp32 and
              bf16, at the main path's leaf shapes (the paper CNN at width
              32, its 16 leaves stacked over K=8 clients) and at
              ResNet-18's largest leaf stacked over K=8; the six sweep
              kernels (fused_axpy, the local and server updates — the
              server's with the scale 1/eta folded in, theta beside an
              fp32 momentum, delta in theta's dtype and in fp32 — the
              weighted reduce, QSGD and the threshold select, one launch
              per 64 leaves, QSGD with each row's scale computed in the
              call, and the sparse reduce, one call of four kernels per
              aggregate) also over
              ResNet-18's 76 leaves (two leaf-table groups), over edge
              sweeps (an empty leaf, lengths off the tile, a leaf not
              16-byte aligned, 65 leaves, k = 0, out-of-range indices; for
              QSGD an all-zero leaf, a NaN and a -0.0, also against
              one-leaf tables with torch.amax scales given) and, for the
              sparse reduce,
              duplicate indices within and across clients; the weighted and the
              sparse reduce also at K=96 bf16 against an fp64 oracle (1
              bf16 ulp);
              the KD forward and backward kernels in fp32 and bf16 at the
              FedADC+ CNN's (512, 10) (K=8 clients x batch 64 folded, 8
              groups of rho), ResNet-18's (512, 100), the reference sweep's
              (31, 257) and (64, 37), an LM vocabulary's (1024, 32768) and
              each forward route's boundary (C 1024 and 1025, the largest C
              one CTA stages and one more), forward within atol 1e-5 +
              rtol 1e-4, backward within 1e-5 of the gradient's largest
              magnitude, and the forward on rows with an out-of-range label
              and ±inf logits (NaN and inf where the plain version has
              them); flash attention in fp32 and
              bf16 at the reference sweep (MHA, GQA 2, MQA at D 128, L 192,
              windows 32/64/128), zamba2-1.2b's prefill (B 4, H 32, L 2048,
              D 64), Qwen3's GQA 32/8 at D 128, and internvl2-26b's 48/8
              and llama4-scout's 40/8 at L 2048, D 128 (GQA groups of 6
              and 5), within 2e-5 / 2e-2 abs +
              rel (bf16 on the tensor cores, fp32 on the CUDA cores); the
              SSD scan (three kernels a call: chunk states, carry, outputs)
              at the reference sweep, ragged L 300 and L 1100, batch 1 at
              L 4096, zamba2-1.2b's prefill (b 4, L 2048, H 64, P 64, N 64,
              chunk 256) and decays that underflow, within 2e-5 / 5e-2 of
              max |y| (bf16 B and C with an fp32 output also within 1e-4),
              its running sums and states in device memory against the
              plain phases; both refuse operands
              that need a gradient; then time each kernel, its
              plain version and, where one PyTorch call computes the same
              function, that call (flash: scaled_dot_product_attention;
              fused_axpy: torch._foreach_add, the per-leaf torch.add sweep
              logged beside it; the weighted reduce: torch.tensordot per
              leaf; the sparse reduce: index_add_ per leaf; the threshold
              select: torch.where per leaf, with v - q beside it, and a
              loop of one-leaf calls; QSGD: the table
              call with the scales given and a loop of one-leaf calls with
              and without torch.amax launches; the local and server
              updates, which no one PyTorch call computes: a loop of
              one-leaf calls, torch._foreach_* chains of the same
              arithmetic, and the output views made by as_strided and by
              one C++ call), flash and the SSD in bf16 at
              the prefill shape too, and both LM kernels at the prefill_32k
              length (L 32768);
2b. shapes  — every shape the reference's Pallas kernels take, beyond the
              kernels' first limits (shapes_phase; the new flash, SSD and
              KD shapes are among phase 2's: flash D 80, 96, 256 with and
              without a window, 40 padded, 320 and 512 on the wide route;
              the SSD at Mamba-2 2.7B's layer (N 128), P and N 128 on a
              ragged L, P 160 x N 192, chunks of 512 and 1000, decays
              that underflow at N 128; the KD pair at each dtype's cluster
              limit and one class more, Gemma's 256,000 classes and (bf16)
              600,000, with the special rows on the split route), each
              call's launches against its plan's: (a) the sparse reduce
              on one leaf of 27,443,201, 65,536,000 and 2**30 + 3
              elements (segments), fp32 and bf16, bit for bit; (b)
              aggregation.sparse_weighted_mean over zamba2-1.2b's 74
              leaves at K 4 x top-k 10%, bit for bit; (c) each new shape
              timed beside its bound (flash also beside
              scaled_dot_product_attention); (d) zamba2-1.2b with d_state
              128, 2 layers, B 1 x L 2048, kernel route vs plain route
              within 1e-3 / 5e-2 of max |logit|, the SSD's three kernels
              in its profile;
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
4. wire     — the same CNN main path on the compressed wire, 4 FedADC
              rounds under the plain wire (the baseline, same seed and
              conditions) and under each of (a) top-k 10% with EF, dense
              wire; (b)
              the same on the sparse (value, index) wire with the sparse
              aggregate; (c) QSGD 4 bits up, delta+QSGD 8 bits down; (d)
              the lossless delta downlink with per-client unicast: exact
              launch counts, measured bytes equal to the configuration's
              wire sizes, (a) and (b) the same update, the round time and
              a profiled round's idle share each;
5. distill  — the same CNN main path under FedADC+ (lambda 0.35, tau 1.0):
              4 rounds with exact launch counts (the FedADC round's update
              kernels plus H kd_loss and H kd_loss_bwd a round), round time
              and a profiled round's idle share beside phase 3's plain
              FedADC round; one round each of the Table I baselines moon,
              fedgkd, fedntd and fedrs at the benchmark's eta 0.05
              (benchmarks/table1_sota.py), whose loss is only logged: at
              this full width it diverges, as FedAvg's does, within the
              round; then one round each at the main path's eta 0.01, which
              must stay finite; then the card (TF32 off) against the CPU on
              a one-step FedADC+ round from the same parameters and
              batches, within 1e-4 relative;
6. resnet   — one FedADC round of ResNet-18 with 100 classes (|S|=8, H=2),
              the kernels timed over its 76 leaves, then one round each
              under the wires (b) and (c) and one FedADC+ round (the KD
              kernels at C=100);
7. quickstart — the port's quickstart (40 rounds of FedAvg and FedADC);
8. personalization — the port's personalization example (20 FedADC+
              rounds, then head calibration with the KD regulariser);
9. serve    — zamba2-1.2b at full width (1,104,937,856 parameters, fp32,
              initialised on the card from a seed): (a) the prefill step's
              kernel route on B 4 x L 2048 prompts (numpy seed 0), exactly
              38 ssd_scan and 6 flash_attention launches a forward, first
              tokens and last-position logits against the use_pallas=False
              route (1e-3 of max |logit| in fp32; 5e-2 in bf16, run once
              more), one profiled prefill; (b) one prefill_32k sequence
              (L 32768), timed, with the same checks; (c) the
              ServingEngine, 4 slots, chunk 16, 8 requests of 32-128 prompt
              tokens and 32 new tokens, greedy then temperature 0.8 /
              top_k 40, and greedy on one slot: every request finishes, the
              batched logits within 1e-4 of max |logit| of the one-slot
              engine's and the tokens equal wherever the top-2 margin
              exceeds that; (d) the card (TF32 off) against the CPU at the
              depth of the first period (6 Mamba2 blocks and the shared
              attention), L 512, within 1e-4 of max |logit|.  Tokens of two
              routes may differ only at a near-tie (top-2 margin under the
              logit bound), which is logged;
10. async   — the semi-async engine on the main path's CNN, data and
              FedConfig (eta 0.01), a fleet of bimodal speeds (a quarter
              4x slower), H_i in (4, 8), 5% drops, buffered-4 flushes:
              (a) 12 flushes on the example's wire (top-k 10% with EF up,
              the unicast delta downlink, resync horizon 2) and (b) the
              same on the sparse wire (the flush launches sparse_reduce):
              every launch against the count the event log predicts (the
              dispatch groups' H_i steps, a select a group on the dense
              wire, an aggregate and a server step a flush), uplink and
              downlink bytes equal to the wire sizes and the unicast
              ledger, stale deltas seen, the event log and staleness
              histogram identical over a second run from the same seeds,
              ms per flush and per dispatch group, a profiled flush's idle
              share; (c) heterogeneity off, buffer_k 0: two flushes against
              two sync rounds from the same parameters and picks, within
              1e-4 relative; (d) the port's async straggler example;
11. fleet   — (a) one main-path round's stacked deltas, dense and as the
              sparse top-k wire, through protocol.aggregate: flat and one
              region bit for bit, four regions within 1e-5 of flat, R + 1
              weighted-reduce launches dense and R sparse-reduce calls + 1
              sparse, each timed; (b) four sync rounds on the top-k + EF
              wire with a FleetScheduler (R = 4) and a PagedClientStore
              whose budget holds 8 EF pages: peak resident bytes within
              the budget, spills and faults logged with their ms, and all
              100 clients' pages bit for bit a plain ClientStore's fed the
              same scatters; (c) checkpoints of the CNN's parameters, FedADC's
              fp32 momentum and bf16, e4m3 and e5m2 copies, and paged pages
              in those dtypes, all bit for bit;
12. bench   — the paper's benchmark drivers (``repro_torch.benchmarks``) on
              the card, each driver's ``main(rows)`` in turn, nothing
              caught: fig1, fig2, the beta ablation, client selection,
              Table I, fig5, fig7 (CNN width 8 on 16x16 images, 20 clients;
              fig1 and clustering at their ROUNDS, the rest at the halved
              ROUNDS BENCH_CUTS gives, each cut logged), the
              straggler bench, the fleet bench's smoke, comm_load and the
              serving bench with its smoke: every row name equal to
              BENCH_ROWS, fig1's FedADC - FedAvg at s=2 above 0, the
              launches of fig1 and of Table I's first FedADC+ run equal to
              what their rounds predict, the fleet smoke's byte fields and
              headline equal to the committed BENCH_fleet.json's, the
              serving smoke's counters to BENCH_serving_smoke.json's,
              comm_load's unicast rows equal to multicast under full
              participation within the resync horizon (h4) and the delta
              downlink within 1.1x raw; each driver's seconds and us
              column, one profiled fig1 round's idle share.  The JSONs go
              to chiprun_out/.
13. telemetry — (a) the main path (phase 3's configuration), 4 rounds
              with telemetry off and the same 4 on, in lockstep from one
              init and stream, cuDNN deterministic: parameters bit for bit
              after every round, every kernel's launches equal, the drift
              curve's keys the reference's, the JSONL schema-valid, the
              round span counted 4 times; both arms' ms, their ratio and a
              profiled round's extra device events; whether a third run at
              cuDNN's defaults differs; (b) one round each of top-k 10% +
              EF dense and sparse (phase 4's (a), (b)) with the EF norm,
              and a one-step round of each on the card and the CPU (TF32
              off): drift within 1e-4 relative; (c) the semi-async engine
              (phase 10's fleet and wire (a), buffered-4, 4 flushes): one
              drift record a flush, its staleness the event log's, span
              counts the dispatch groups, flushes and broadcasts, launches
              the event log's; (d) the serving bench's TINY engine, 8
              requests: a request event each, tokens counted, a valid
              summary; (e) telemetry_bench (10 rounds, warm-up 2) and
              comm_sweep (10 sync rounds, 10 async, 8 intermittent),
              cuDNN deterministic: the reference's row names, telemetry
              leaving the accuracy alone, every byte field equal to its
              prediction from the uploads, dispatches, catch-ups and
              resyncs and the wire sizes, the lossless downlink and
              intermittent accuracies equal;
14. archs   — the rest of the LM stack at full width, each model from seed
              0 on the card and freed before the next, its peak memory
              logged, TF32 off for the fp32 ones: (a) internvl2-26b whole
              in bf16 (19,867,557,888 parameters), B 1 of 256 seeded patch
              embeddings and 1,792 tokens: exactly 48 flash launches in the
              kernel route's forward, none in the plain route's, last-
              position logits within 5e-2 of max |logit|; (b) llama4-scout
              at depth 4 (layers 0-2 windowed at 8192, layer 3 global;
              10,877,383,680 parameters), B 2 x L 2048: exactly 1 flash
              launch, both routes' (token, expert) assignments the same
              (else each differing token's top-2 gap under 1e-5, and the
              routes again dropless), logits within 1e-3, aux within
              1e-5 relative; 16 decode steps at a dropless capacity (E /
              top_k: 8.0 drops at these routers) against the forward of
              their tokens (the reference's 2e-2); the ServingEngine, 4
              slots, 8 requests of 32 tokens and 16 new, greedy; (c)
              deepseek-v3 at depth 4 (three dense MLA layers, one of 256
              experts top-8; 15,111,101,440 parameters), a B 1 x L 1024
              prefill with no flash launch, then 16 absorbed-MLA decode
              steps against the dropless forward of their tokens (2e-2);
              (d) whisper-small, 1500 seeded frames and
              64 tokens, card against CPU within 1e-3 of max |logit|, 16
              decode steps after prefill_cross against the forward (2e-2);
              (e) xlstm-350m, B 1 x L 512, card against CPU within 1e-3, the
              sLSTM loops' share of the forward; 32 decode steps card
              against CPU (1e-3) and, on the mLSTM blocks 0-2, against the
              forward (2e-2): the sLSTM's norm spans the forward's whole
              sequence (the reference's), so the whole model's decode is
              not the forward's prefix, which is logged;
15. pod     — the pod engine (``repro_torch.launch.train``), nothing
              caught: (a) zamba2-1.2b at full width from seed 0, the mixed
              round (bf16 broadcast and local steps, fp32 master θ and m),
              remat full, FedADC nesterov at eta 0.01, CP 1 x CS 4 x H 2 of
              B 2 x L 2048 make_token_dataset tokens at vocab 32,000: three
              rounds, the update kernels' launches equal to the leaf
              tables' prediction, θ and m fp32 and finite, θ moved and m
              non-zero every round, the third round under
              torch.cuda.set_sync_debug_mode("error"), the median of rounds
              2-3 and the peak memory, a fourth round profiled (device
              time by kernel, idle share, every GEMM kind and the GEMMs'
              ms on the tensor and on the CUDA cores); (b) FedADC+ (lambda 0.35, tau 1.0)
              on that state, a warm-up round then one with exactly CS·H
              KD forward and backward launches at (b·(L − 1), 32,000)
              bf16, and one KD call pair timed there with its plain
              version and bound; (c) a fleet of 8 on the same model, top-k
              10% + EF on clients 0-3 then 2-5: the EF store's untouched
              rows bit for bit, the touched ones changed, the
              threshold-select launches, uplink bytes equal to the wire
              formula; then one round of the sparse-native top-k wire;
              (d) lm_round's model: QSGD 4 bits up with delta+QSGD 8 bits
              down (the reference in state["refs"]), a heavy-ball round,
              the delta unicast counters against the wire sizes, CP 2
              against CP 1 over the same clients (1e-4 of max |Δθ|, fp32,
              TF32 off), one fleet region and telemetry on bit for bit
              against flat and off, and use_pallas=True refused (the LM
              kernels have no backward); (e) one fp32 FedADC round of
              qwen3-4b and zamba2-1.2b at reduced() on the card and on the
              CPU, within 1e-4 of max |Δθ|; (f) lm_round.main (ROUNDS cut
              to 30) and pod_finetune (--rounds 10) with its checkpoint
              restored bit for bit;
16. tools   — the launch tooling and the analysis, nothing caught: (a) the
              dry-run (``python -m repro_torch.launch.dryrun``, one process
              a cell, all started together) of zamba2-1.2b at the four
              SHAPES and llama4-scout at train_4k on the meta device, each
              line's counted and model FLOPs, useful fraction, bytes, the
              three roofline terms and the dominant one, and the lines
              through roofline_report; (b) phase 15's mixed round counted
              on meta at its shape (CP 1 x CS 4 x H 2 of B 2 x L 2048) and
              divided by the median round time phase 15 measured: the
              achieved TFLOP/s, and by the operands' dtype each one's
              TFLOP/s and share of its peak (bf16 on the tensor cores,
              fp32 on the CUDA cores; spec sheet, by the card's name), the
              least time the counted FLOPs take at those peaks, and each
              dtype's FLOPs over the profiled round's GEMM time of its
              class, which fails above the peak; and phase 15's state
              bytes on the card (torch.cuda.memory_allocated around
              init_state) against inputs.state_inputs' meta count, within
              the caching allocator's rounding; (c) kernels_bench on the
              card (all eleven kernels, CUDA events), its
              BENCH_kernels_torch.json in chiprun_out/ held by
              check_regression against the committed CPU run's with
              --require sparse_aggregate; (d) the analysis: the AST rules
              clean against analysis_baseline_torch.json, the kernel
              coverage audit clean, and the per-round audit on the card
              (the sync engine on the plain wire and top-k + EF, the async
              engine; equal aten ops and kernel launches in rounds 1 and
              2, no kernel library loaded again).

``python3 chip_smoke.py --pod-round-counts`` only counts phase 15's mixed
round on the meta device (phase 16 (b) runs it as a process of its own)
and prints the counts as one JSON line; it needs no card.

Every time is measured here, on the card named in the output.  Bounds use
the H100 SXM data sheet: 3.35 TB/s of HBM, 67 TFLOP/s of fp32 outside the
tensor cores and 989 TFLOP/s of bf16 in them.
"""
import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TPU_KERNEL = {
    "fused_axpy": "src/repro/kernels/fedadc_update.py:62",
    "local_update": "src/repro/kernels/fedadc_update.py:66",
    "server_update": "src/repro/kernels/fedadc_update.py:71",
    "weighted_reduce": "src/repro/kernels/weighted_reduce.py:45",
    "threshold_select": "src/repro/kernels/compress.py:85",
    "qsgd": "src/repro/kernels/compress.py:80",
    "sparse_reduce": "src/repro/kernels/sparse_reduce.py:53",
    # the Pallas kd_loss has no backward; kd_loss_bwd is its gradient
    "kd_loss": "src/repro/kernels/kd_loss.py:55",
    "kd_loss_bwd": "src/repro/kernels/kd_loss.py:55",
    "flash_attention": "src/repro/kernels/flash_attention.py:74",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:58",
}
UPDATE_SOURCE = "src/repro_torch/csrc/fedadc_kernels.cu"
WIRE_SOURCE = "src/repro_torch/csrc/compress_kernels.cu"
KD_SOURCE = "src/repro_torch/csrc/kd_kernels.cu"
SOURCE = {name: (WIRE_SOURCE if name in ("threshold_select", "qsgd",
                                         "sparse_reduce")
                 else KD_SOURCE if name.startswith("kd_") else UPDATE_SOURCE)
          for name in TPU_KERNEL}
SOURCE["flash_attention"] = "src/repro_torch/csrc/attention_kernels.cu"
SOURCE["ssd_scan"] = "src/repro_torch/csrc/ssd_kernels.cu"
# the sweep kernels whose device time is logged beside their library call's
SWEEP_KERNELS = ("fused_axpy", "weighted_reduce", "threshold_select",
                 "sparse_reduce")
K = 8
ETA = 0.01
TOPK_FRAC = 0.1
# the wire configurations of phase 4, on top of the main path's FedConfig
WIRES = {
    "plain": {},          # the uncompressed wire, the phase's baseline
    "a_topk_dense": dict(compressor="topk", topk_frac=TOPK_FRAC),
    "b_topk_sparse": dict(compressor="topk", topk_frac=TOPK_FRAC,
                          sparse_uplink=True, sparse_aggregate=True),
    "c_qsgd_delta_qsgd": dict(compressor="qsgd", qsgd_bits=4,
                              downlink_compressor="delta+qsgd",
                              downlink_qsgd_bits=8),
    "d_delta_unicast": dict(downlink_compressor="delta",
                            downlink_unicast=True),
}


def log(*a):
    print(*a, flush=True)


def kernel_name(mangled):
    """A readable name for a mangled kernel symbol: its namespaces and name
    (the anonymous namespace dropped) and an integer template argument."""
    i = mangled.find("_ZN")
    if i < 0:
        return mangled
    i, parts = i + 3, []
    while i < len(mangled) and mangled[i].isdigit():
        j = i
        while mangled[j].isdigit():
            j += 1
        parts.append(mangled[j:j + int(mangled[i:j])])
        i = j + int(mangled[i:j])
    name = "::".join(p for p in parts if not p.startswith("_GLOBAL__N"))
    m = re.match(r"I(f|13__nv_bfloat16)?((?:L[ib]\d+E)*)", mangled[i:])
    args = ([] if not m or not m.group(1)
            else ["f32" if m.group(1) == "f" else "bf16"])
    args += re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
    return f"{name}<{', '.join(args)}>" if args else name


def ptxas_usage(build_log):
    """[(kernel, registers, spill-store bytes)] from ptxas -v output."""
    out, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, spill = kernel_name(m.group(1)), 0
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append((name, int(m.group(1)), spill))
            name = None
    return out


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


def device_ms_by_kernel(torch, fn, iters=20):
    """{kernel name: device ms a call} of fn, from the profiler over
    `iters` calls: what the card spends, whatever the host adds."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:48]: e.self_device_time_total / 1e3 / iters
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


# the KD kernels' check shapes: (rows, classes, groups of rho)
KD_SHAPES = [(512, 10, 8), (512, 100, 8), (31, 257, 1), (64, 37, 1),
             (1024, 32768, 1)]
KD_LAM, KD_TAU = 0.35, 1.0
KD_TAU_GENERAL = 3.0   # the backward's route for tau != 1 (not a power of 2)
# the Table I baselines of phase 5, and the benchmark's eta for them
BASELINES = ("moon", "fedgkd", "fedntd", "fedrs")
TABLE1_ETA = 0.05


def cdiv(a, b):
    return -(-a // b)


def table_groups(n_leaves):
    """Leaf-table groups a sweep of n_leaves takes: one launch each."""
    return cdiv(n_leaves, 64)


def time_library(torch, lib, **kw):
    """(the row's library ms, {label: ms}) for a yardstick: None, one call,
    or a dict of labelled calls whose first is the row's."""
    if lib is None:
        return None, {}
    if not isinstance(lib, dict):
        ms = cuda_ms(torch, lib, **kw)
        return ms, {}
    times = {label: cuda_ms(torch, fn, **kw) for label, fn in lib.items()}
    return next(iter(times.values())), times


def topk_k(n):
    return max(1, math.ceil(TOPK_FRAC * n))


def bound(kernel, sizes, k=K):
    """(bound_ms, bound_by) for one sweep of `kernel` over leaves of the
    given element counts, fp32: each input read once, each output written
    once, against the HBM rate and the fp32 rate.  The sparse reduce reads
    the K top-k wires (value + 4-byte index per pair, k = ⌈0.1·n⌉ per
    leaf) and writes the fp32 leaf."""
    n = sum(sizes)
    pairs = k * sum(topk_k(m) for m in sizes)
    nbytes, flops = {
        "fused_axpy": (3 * 4 * k * n, 2 * k * n),
        "local_update": (4 * 4 * k * n, 3 * k * n),
        # Δ̄ = s·Δ folded in: one more multiply, no more bytes
        "server_update": (5 * 4 * n, 5 * n),
        "weighted_reduce": (4 * (k + 1) * n, 2 * k * n),
        "threshold_select": (3 * 4 * k * n, 2 * k * n),
        "qsgd": (4 * 4 * k * n, 9 * k * n),
        "sparse_reduce": (8 * pairs + 4 * n, 2 * pairs),
    }[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kd_bound(kernel, rows, n_classes, groups, elem_bytes=4):
    """(bound_ms, bound_by) of one KD kernel call: each input read once and
    each output written once, against the HBM rate; operations counted from
    the source per element (forward: 3 exps, 1 log, 4 divides and about 20
    adds, multiplies and compares; backward on the route KD_TAU takes, at
    τ = 1 2 exps and about 12 more, else 3 exps, 2 scalings by 1/τ and the
    same 12), against the fp32 rate."""
    n = rows * n_classes
    common = 2 * elem_bytes * n + 8 * rows + 4 * groups * n_classes
    nbytes, flops = {
        # + loss, ce, kl and 5 statistics a row
        "kd_loss": (common + 4 * 8 * rows, 28 * n),
        # + statistics and upstream gradient read, ds written
        "kd_loss_bwd": (common + 4 * 6 * rows + elem_bytes * n,
                        (14 if KD_TAU == 1.0 else 17) * n),
    }[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kd_operands(torch, rows, n_classes, groups, dtype, gen):
    """Random KD operands on the card: logits (2σ), labels, ρ (one class
    fully confident, so its target sits at the clip), upstream gradient."""
    s, t = ((2 * torch.randn(rows, n_classes, generator=gen)).to("cuda", dtype)
            for _ in range(2))
    y = torch.randint(0, n_classes, (rows,), generator=gen).cuda()
    rho = torch.rand(groups, n_classes, generator=gen).cuda()
    rho[:, 0] = 1.0
    g = torch.rand(rows, generator=gen).cuda()
    return s, t, y, rho, g


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
    ds = [rnd(*s) for s in shapes]       # mean_delta in θ's dtype
    w = torch.rand(K, generator=gen).to(dev)
    a, eta, gamma, ae, sc = -0.05, 0.05, 0.2, 0.05, 1 / ETA
    return {
        "fused_axpy": (
            lambda: FU.fused_axpy_leaves(xs, ys, a),
            lambda: [ref.fused_axpy(x, y, a) for x, y in zip(xs, ys)],
            {"_foreach_add": lambda: torch._foreach_add(xs, ys, alpha=a),
             "torch.add per leaf": lambda: [torch.add(x, y, alpha=a)
                                            for x, y in zip(xs, ys)]}),
        "local_update": (
            lambda: FU.local_update_leaves(xs, ys, zs, eta),
            lambda: [ref.fedadc_local_update(x, y, z, eta)
                     for x, y, z in zip(xs, ys, zs)],
            None),
        # the server step as the strategies call it: Δ̄ = mean_delta/η
        # folded in
        "server_update": (
            lambda: list(zip(*FU.server_update_leaves(th, ms, ds, gamma, ae,
                                                      sc))),
            lambda: [ref.fedadc_server_update(t, m, d, gamma, ae, sc)
                     for t, m, d in zip(th, ms, ds)],
            None),
        "weighted_reduce": (
            lambda: WR.weighted_reduce_leaves(xs, w),
            lambda: [ref.weighted_delta_reduce(x, w) for x in xs],
            lambda: [torch.tensordot(w, x, 1) for x in xs]),
    }


def wire_sweeps(torch, CP, SR, ref, shapes, dtype, gen):
    """The three wire kernels as `sweeps` gives the update kernels: per
    kernel (kernel sweep, plain sweep, library sweep or None) over leaves of
    `shapes` stacked over K clients, on random operands in `dtype`; the
    reduce takes each leaf's K top-k wires (unique indices per client)."""
    dev = "cuda"
    vs = [torch.randn((K, *s), generator=gen).to(dev, dtype) for s in shapes]
    us = [torch.rand((K, *s), generator=gen).to(dev, dtype) for s in shapes]
    taus = [torch.topk(v.reshape(K, -1).abs(), topk_k(v[0].numel()),
                       dim=1).values[:, -1].contiguous() for v in vs]
    tau_flat = torch.cat(taus).float()

    def where(v, t):
        return torch.where(v.abs() >= t.reshape((K,) + (1,) * (v.dim() - 1)),
                           v, zero)
    wires = []
    for v in vs:
        flat = v.reshape(K, -1)
        idx = torch.topk(flat.abs(), topk_k(flat.shape[1]), dim=1).indices
        wires.append((torch.gather(flat, 1, idx).contiguous(),
                      idx.to(torch.int32).contiguous(), tuple(v.shape[1:])))
    wire_lists = ([v for v, _, _ in wires], [i for _, i, _ in wires])
    shape_list = [s for _, _, s in wires]
    w = torch.rand(K, generator=gen).to(dev)
    zero = torch.zeros((), device=dev, dtype=dtype)
    # the library yardstick of the reduce: index_add_ of the premultiplied
    # pairs into one preallocated fp32 buffer per leaf
    lib_pairs = [((w[:, None] * vals.float()).reshape(-1),
                  idx.reshape(-1).long(),
                  torch.zeros(math.prod(shape), device=dev))
                 for vals, idx, shape in wires]
    return {
        # the table call, one fp32 threshold a row of every leaf, against
        # the per-leaf plain version; torch.where computes q only, so the
        # two-call yardstick with v - q is logged beside it
        "threshold_select": (
            lambda: list(zip(*CP.threshold_select_leaves(vs, tau_flat))),
            lambda: [ref.topk_threshold_select(v, t)
                     for v, t in zip(vs, taus)],
            {"torch.where": lambda: [where(v, t) for v, t in zip(vs, taus)],
             "torch.where + sub": lambda: [(lambda q: (q, v - q))(where(v, t))
                                           for v, t in zip(vs, taus)]}),
        # the table call, each row's scale computed in it, against the plain
        # version with torch.amax scales (the same function)
        "qsgd": (
            lambda: list(zip(*CP.qsgd_leaves(vs, us, 15))),
            lambda: [ref.qsgd_quantize(
                v, u, torch.amax(v.reshape(K, -1).abs(), dim=1), 15)
                for v, u in zip(vs, us)],
            None),
        "sparse_reduce": (
            lambda: SR.sparse_reduce_leaves(*wire_lists, w, shape_list,
                                            dtype),
            lambda: [ref.sparse_weighted_delta_reduce(vals, idx, w, shape,
                                                      dtype)
                     for vals, idx, shape in wires],
            lambda: [buf.index_add_(0, i, wv) for wv, i, buf in lib_pairs]),
    }


def qsgd_yardsticks(torch, CP, shapes, gen, iters=30):
    """{label: ms} of the QSGD sweep over leaves of `shapes` stacked over K
    (fp32): the table call with the scales given, a loop of one-leaf calls
    (``CP.qsgd``, a table of one) with the scales given and with a
    torch.amax launch a leaf (the earlier main path's pattern), beside the
    table call with the scales folded in (the row's ms)."""
    vs = [torch.randn((K, *s), generator=gen).cuda() for s in shapes]
    us = [torch.rand((K, *s), generator=gen).cuda() for s in shapes]
    scales = [torch.amax(v.reshape(K, -1).abs(), dim=1) for v in vs]
    flat = torch.cat(scales)
    calls = {
        "one-leaf loop, scales given": lambda: [
            CP.qsgd(v, u, sc, 15) for v, u, sc in zip(vs, us, scales)],
        "one-leaf loop + amax": lambda: [
            CP.qsgd(v, u, torch.amax(v.reshape(K, -1).abs(), dim=1), 15)
            for v, u in zip(vs, us)]}
    # a checkout from before the leaf table (--kernel-times --src) has
    # only the one-leaf call
    if hasattr(CP, "qsgd_leaves"):
        calls["table, scales folded"] = lambda: CP.qsgd_leaves(vs, us, 15)
        calls["table, scales given"] = lambda: CP.qsgd_leaves(
            vs, us, 15, scales=flat)
    times = {label: cuda_ms(torch, fn, iters=iters)
             for label, fn in calls.items()}
    if "table, scales folded" in calls:
        times["device ms by kernel, table"] = device_ms_by_kernel(
            torch, calls["table, scales folded"])
    return times


def select_yardsticks(torch, CP, shapes, gen, iters=30):
    """{label: ms} of the top-k threshold select over leaves of `shapes`
    stacked over K (fp32, τ each row's 10%-th largest |v|): the table call
    where the checkout has it, a loop of one-leaf calls (the per-leaf kernel
    before the table, a table of one after it), torch.where (q only) and
    torch.where with v - q (the same function in two calls a leaf), and the
    device ms by kernel of the table call, or of the loop without one."""
    vs = [torch.randn((K, *s), generator=gen).cuda() for s in shapes]
    taus = [torch.topk(v.reshape(K, -1).abs(), topk_k(v[0].numel()),
                       dim=1).values[:, -1].contiguous() for v in vs]
    flat = torch.cat(taus)
    zero = torch.zeros((), device="cuda")

    def where(v, t):
        return torch.where(v.abs() >= t.reshape((K,) + (1,) * (v.dim() - 1)),
                           v, zero)
    calls = {
        "one-leaf loop": lambda: [CP.threshold_select(v, t)
                                  for v, t in zip(vs, taus)],
        "torch.where": lambda: [where(v, t) for v, t in zip(vs, taus)],
        "torch.where + sub": lambda: [(lambda q: (q, v - q))(where(v, t))
                                      for v, t in zip(vs, taus)]}
    # a checkout from before the select table (--kernel-times --src) has
    # only the one-leaf call
    table = hasattr(CP, "threshold_select_leaves")
    if table:
        calls["table"] = lambda: CP.threshold_select_leaves(vs, flat)
    times = {label: cuda_ms(torch, fn, iters=iters)
             for label, fn in calls.items()}
    times["device ms by kernel"] = device_ms_by_kernel(
        torch, calls["table" if table else "one-leaf loop"])
    return times


def kd_yardsticks(torch, KD, gen, iters=30):
    """{label: ms} of the KD forward and backward (wall by CUDA events over
    `iters` calls, and device ms by kernel) at the FedADC+ CNN's folded
    (512, 10) with 8 groups of ρ in fp32 (there also the host time of the
    call), an LM vocabulary's (1024, 32768) in fp32 and bf16, 8 rows of
    it in fp32 and the pod round's (4094, 32000) in bf16; then one vmapped grad_and_value of self_confidence_kd_loss
    over K=8 clients of 64 rows of 10 classes, phase 5's Function path
    (the vmap rules' folds and checks around both kernels): wall over 200
    calls, host time and device ms by kernel."""
    from repro_torch.core import distillation as D
    out = {}
    for rows, n_classes, groups, dtype in (
            (512, 10, 8, torch.float32), (1024, 32768, 1, torch.float32),
            (1024, 32768, 1, torch.bfloat16), (8, 32768, 1, torch.float32),
            (4094, 32000, 1, torch.bfloat16)):
        s_, t_, y_, rho_, g_ = kd_operands(torch, rows, n_classes, groups,
                                           dtype, gen)
        stats_ = KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)[3]
        calls = {"kd_loss": lambda: KD.kd_loss(s_, t_, y_, rho_, KD_LAM,
                                               KD_TAU),
                 "kd_loss_bwd": lambda: KD.kd_loss_bwd(
                     s_, t_, y_, rho_, stats_, g_, KD_LAM, KD_TAU)}
        for name, call in calls.items():
            tag = f"{name} ({rows}, {n_classes}) G={groups} {dtype}"
            out[tag] = cuda_ms(torch, call, iters=iters)
            out[f"{tag}, device ms by kernel"] = device_ms_by_kernel(torch,
                                                                     call)
            if n_classes == 10:
                out[f"{tag}, host"] = host_ms(call)
        if n_classes == 10:
            # host steps of the backward's call and vmap rule, each alone:
            # the operand checks, and the fold of its six operands (the
            # folded client axis of K=8 clients of 64 rows) or of g alone
            dev = s_.get_device()
            out["host: check_operands of stats and g"] = host_ms(
                lambda: (KD.check_operands("kd_loss_bwd", stats_,
                                           dtype=torch.float32,
                                           shape=stats_.shape, device=dev),
                         KD.check_operands("kd_loss_bwd", g_,
                                           dtype=torch.float32,
                                           shape=g_.shape, device=dev)))
            out["host: _check of s, t, labels, rho"] = host_ms(
                lambda: KD._check("kd_loss_bwd", s_, t_, y_, rho_))
            six = (s_.view(8, -1, n_classes), t_.view(8, -1, n_classes),
                   y_.view(8, -1), rho_.view(8, 1, n_classes),
                   stats_.view(8, -1, stats_.shape[1]), g_.view(8, -1))
            out["host: _fold of the six backward operands"] = host_ms(
                lambda: KD._fold(8, (0,) * 6, six))
            out["host: _fold of g alone"] = host_ms(
                lambda: KD._fold(8, (0,), six[5:]))
    k, b, n_classes = 8, 64, 10
    s_, t_ = (torch.randn(k, b, n_classes, generator=gen).cuda()
              for _ in range(2))
    y_ = torch.randint(0, n_classes, (k, b), generator=gen).cuda()
    counts = torch.randint(0, 50, (k, n_classes), generator=gen).cuda()
    step = torch.func.vmap(torch.func.grad_and_value(
        lambda s, t, y, c: D.self_confidence_kd_loss(s, t, y, c, KD_LAM,
                                                     KD_TAU)[0]))
    call = lambda: step(s_, t_, y_, counts)
    tag = f"vmapped grad_and_value of self_confidence_kd_loss K={k} x {b} x "
    tag += f"{n_classes} fp32"
    out[tag] = cuda_ms(torch, call, iters=200)
    out[f"{tag}, host"] = host_ms(call)
    out[f"{tag}, device ms by kernel"] = device_ms_by_kernel(torch, call)
    return out


def host_ms(fn, iters=200):
    """Mean host time of fn() over `iters` calls, for host-only work."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def update_yardsticks(torch, FU, shapes, gen, iters=30):
    """{label: ms} of the local and server update sweeps over leaves of
    `shapes` (fp32; the local step's stacked over K): the table calls,
    where the checkout has them (the server's with Δ̄ = Δ/η folded in and
    with scale 1); a loop of one-leaf calls (the per-leaf kernel before the
    tables, a table of one after them), the server's also with Δ̄ = Δ/η
    formed by a launch a leaf first (the earlier main path's pattern);
    torch._foreach_* chains of the same arithmetic (timing only: no one
    call computes these functions); the host time of the outputs' views
    made by as_strided a leaf and by one C++ call
    (unflatten_dense_tensors); and the device ms by kernel of the table
    calls, or of the one-leaf loops where there are no tables."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen).cuda()
    xs, ys, zs = ([rnd(K, *s) for s in shapes] for _ in range(3))
    th, ms, ds = ([rnd(*s) for s in shapes] for _ in range(3))
    eta, gamma, ae, sc = 0.05, 0.2, 0.05, 1 / ETA

    def local_chain():
        step = torch._foreach_add(ys, zs)
        torch._foreach_mul_(step, eta)
        return torch._foreach_sub(xs, step)

    def server_chain():
        m_new = torch._foreach_mul(ms, gamma)
        torch._foreach_add_(m_new, torch._foreach_mul(ds, sc))
        return torch._foreach_sub(th, torch._foreach_mul(m_new, ae)), m_new
    calls = {
        "local one-leaf loop": lambda: [
            FU.local_update(x, y, z, eta) for x, y, z in zip(xs, ys, zs)],
        "local _foreach chain": local_chain,
        "server one-leaf loop, delta_bar given": lambda: [
            FU.server_update(t, m, d, gamma, ae)
            for t, m, d in zip(th, ms, ds)],
        "server one-leaf loop + scale": lambda: [
            FU.server_update(t, m, d * sc, gamma, ae)
            for t, m, d in zip(th, ms, ds)],
        "server _foreach chain": server_chain}
    # a checkout from before the update tables (--kernel-times --src) has
    # only the one-leaf calls
    tables = hasattr(FU, "local_update_leaves")
    if tables:
        calls["local table"] = lambda: FU.local_update_leaves(xs, ys, zs,
                                                              eta)
        calls["server table, scale folded"] = lambda: \
            FU.server_update_leaves(th, ms, ds, gamma, ae, sc)
        calls["server table, scale 1"] = lambda: FU.server_update_leaves(
            th, ms, ds, gamma, ae)
    times = {label: cuda_ms(torch, fn, iters=iters)
             for label, fn in calls.items()}
    # the views a table call hands out: one per leaf of one padded buffer
    geometry, templates, picks, off = [], [], [], 0
    for shape in shapes:
        n, pad = math.prod(shape), -math.prod(shape) % 8
        st = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            st[d] = st[d + 1] * shape[d + 1]
        geometry.append((shape, tuple(st), off))
        picks.append(len(templates))
        templates.append(torch.empty(shape, device="meta"))
        if pad:
            templates.append(torch.empty(pad, device="meta"))
        off += n + pad
    buf = torch.empty(off, device="cuda")
    unflatten = torch._C._nn.unflatten_dense_tensors
    times["host: views by as_strided"] = host_ms(
        lambda: [buf.as_strided(sh, st, o) for sh, st, o in geometry])
    times["host: views by one C++ call"] = host_ms(
        lambda: (lambda out: [out[i] for i in picks])(
            unflatten(buf, templates)))
    # the kernels' own time: the table calls', or the one-leaf loops' of a
    # checkout without them
    for step, label in (("local", "local table" if tables
                         else "local one-leaf loop"),
                        ("server", "server table, scale folded" if tables
                         else "server one-leaf loop, delta_bar given")):
        times[f"device ms by kernel, {step}"] = device_ms_by_kernel(
            torch, calls[label])
    return times


def kernel_times(torch, gen):
    """{label: ms} of the kernels this run's yardsticks compare across
    checkouts: the SSD scan at zamba2-1.2b's prefill shape and at L 32768
    (batch 1), B, C and y in fp32 and bf16 (30 calls; 10 at L 32768), and
    QSGD's qsgd_yardsticks over the CNN's 16 leaves and ResNet-18's largest
    leaf, the update sweeps' update_yardsticks and the threshold select's
    select_yardsticks over the CNN's 16 leaves, ResNet-18's 76 and its
    largest leaf, the KD pair's kd_yardsticks; flash attention at
    zamba2-1.2b's prefill shape in fp32 and bf16 and the sparse reduce of
    the CNN's 16 leaves (K 8 top-k wires, fp32), 30 calls each."""
    from repro_torch.kernels import compress as CP
    from repro_torch.kernels import fedadc_update as FU
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kd_loss as KD
    from repro_torch.kernels import ref
    from repro_torch.kernels import sparse_reduce as SR
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.vision import cnn_init, resnet18_init
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = flash_operands(torch, FLASH_SHAPES[7], dtype, gen)
        out[f"flash_attention prefill {dtype}"] = cuda_ms(
            torch, lambda: FA.flash_attention(q, k, v, True, 0))
        out[f"flash_attention prefill {dtype}, device ms by kernel"] = \
            device_ms_by_kernel(torch, lambda: FA.flash_attention(
                q, k, v, True, 0))
        del q, k, v
    kern = wire_sweeps(torch, CP, SR, ref, leaf_shapes(cnn_init(
        0, width=32, image_size=32, device="cpu")), torch.float32,
        gen)["sparse_reduce"][0]
    out["sparse_reduce CNN fp32"] = cuda_ms(torch, kern)
    for tag, shape in (("prefill", SSD_SHAPES[-1]),
                       ("L 32768", (1, LONG_L, 64, 64, 64, 256))):
        for dtype in (torch.float32, torch.bfloat16):
            xdt, a, Bm, Cm = ssd_operands(torch, shape, dtype, gen)
            out[f"ssd_scan {tag} {dtype}"] = cuda_ms(
                torch, lambda: SSD.ssd_scan(xdt, a, Bm, Cm, 256, dtype),
                iters=30 if tag == "prefill" else 10)
            if tag == "prefill":
                out[f"ssd_scan {tag} {dtype}, device ms by kernel"] = \
                    device_ms_by_kernel(torch, lambda: SSD.ssd_scan(
                        xdt, a, Bm, Cm, 256, dtype))
            del xdt, a, Bm, Cm
    cnn_shapes = leaf_shapes(cnn_init(0, width=32, image_size=32,
                                      device="cpu"))
    for tag, shapes in (("CNN", cnn_shapes),
                        ("ResNet-18's largest leaf", [(512, 512, 3, 3)])):
        out[f"qsgd {tag}"] = qsgd_yardsticks(torch, CP, shapes, gen)
    resnet_shapes = leaf_shapes(resnet18_init(0, n_classes=100,
                                              device="cpu"))
    for tag, shapes in (("CNN", cnn_shapes),
                        ("ResNet-18's 76 leaves", resnet_shapes),
                        ("ResNet-18's largest leaf", [(512, 512, 3, 3)])):
        out[f"updates {tag}"] = update_yardsticks(torch, FU, shapes, gen)
        out[f"threshold_select {tag}"] = select_yardsticks(torch, CP, shapes,
                                                           gen)
    out.update(kd_yardsticks(torch, KD, gen))
    return out


def kernel_times_main(src):
    """--kernel-times: build the port of the checkout whose ``src`` is
    given (its own build directory) and print one JSON line, the card's
    name and power limit and kernel_times.  Two checkouts compare on one
    card in turns (this, other, other, this)."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    src = Path(src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build
    build.build_all()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    gen = torch.Generator().manual_seed(0)
    print(json.dumps({"src": str(src), "card": smi,
                      **kernel_times(torch, gen)}), flush=True)
    return 0


def profiled(torch, fn, cpu=True):
    """Run ``fn()`` once under the profiler -> (its wall ms, the device
    kernels as (name, ms, count) rows by time, their summed ms).  Only
    device-side events count, so no time counts twice; ``cpu=False``
    records no host operators (a zamba2 round's ~70,000 kernels take
    minutes to aggregate with them)."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(key=lambda r: -r[1])
    return wall_ms, rows, sum(r[1] for r in rows)


def idle_share(tag, what, wall_ms, rows, busy_ms, steady_ms, top):
    """Log a profiled call's device time by kernel and its idle share
    against ``steady_ms``, the median unprofiled call -> the idle share, or
    None where the profiler saw no device time."""
    if busy_ms > 0:
        log(f"{tag}: kernels busy {busy_ms:.3f} ms in {len(rows)} kinds; "
            f"profiled {what} wall {wall_ms:.3f} ms; unprofiled median "
            f"{what} {steady_ms:.3f} ms; idle share "
            f"{1 - busy_ms / steady_ms:.3f} of the unprofiled {what}")
        for key, ms, count in rows[:top]:
            log(f"{tag}:   {ms:9.3f} ms  x{count:<5} {key[:90]}")
        return 1 - busy_ms / steady_ms
    log(f"{tag}: the profiler recorded no device time (not measured)")
    return None


# words of a GEMM kernel's name (cuBLAS, cuBLASLt's nvjet, CUTLASS)
GEMM_WORDS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
# words of one that runs on the tensor cores (bf16/fp16, TF32)
TENSOR_CORE_WORDS = ("nvjet", "bf16", "f16", "tf32", "s16816", "tensorop",
                     "hmma", "wgmma")


def gemm_class(name):
    """"tensor cores" or "cuda cores" for a GEMM kernel's name (fp32
    without TF32, PyTorch's default for matmul, runs on the CUDA cores),
    None for any other kernel."""
    n = name.lower()
    if not any(w in n for w in GEMM_WORDS):
        return None
    return "tensor cores" if any(w in n for w in TENSOR_CORE_WORDS) \
        else "cuda cores"


def gemm_ms(tag, rows):
    """Log every GEMM kind of a profile's ``rows`` in full and -> the
    device ms of its GEMMs by class (``gemm_class``)."""
    total = {"tensor cores": 0.0, "cuda cores": 0.0}
    for key, ms, count in rows:
        cls = gemm_class(key)
        if cls is not None:
            total[cls] += ms
            log(f"{tag}: GEMM ({cls}) {ms:9.3f} ms x{count:<5} {key[:160]}")
    log(f"{tag}: GEMMs on the tensor cores {total['tensor cores']:.3f} ms, "
        f"on the CUDA cores {total['cuda cores']:.3f} ms, of "
        f"{sum(r[1] for r in rows):.3f} busy ms in {len(rows)} kinds")
    return total


def profile_round(torch, sim, round_s, tag, top=12):
    """Profile one more round of `sim`: device time by kernel, and the idle
    share against the median of the unprofiled rounds after the first.
    -> the idle share, or None where the profiler saw no device time."""
    inputs = sim.next_round_inputs()
    wall_ms, rows, busy_ms = profiled(torch, lambda: sim.run_round(*inputs))
    steady_ms = sorted(round_s[1:])[len(round_s[1:]) // 2] * 1e3
    return idle_share(tag, "round", wall_ms, rows, busy_ms, steady_ms, top)


def expected_wire_launches(tag, rounds, n_leaves, h_steps):
    """The launches `rounds` nesterov FedADC rounds make on wire `tag`:
    the axpy, the server update, the weighted reduce, QSGD and the
    threshold select one launch a sweep (per 64 leaves), the sparse reduce
    one call an aggregate."""
    groups = table_groups(n_leaves)
    per_round = {"fused_axpy": 2 * h_steps * groups,
                 "local_update": 0,
                 "server_update": groups,
                 # every wire but (b) aggregates dense
                 "weighted_reduce": 0 if tag == "b_topk_sparse" else groups,
                 "threshold_select": groups if tag == "a_topk_dense" else 0,
                 # QSGD on the uplink and on the θ delta of the downlink
                 # (FedADC's ctx is derived from it, not sent)
                 "qsgd": 2 * groups if tag == "c_qsgd_delta_qsgd" else 0,
                 "sparse_reduce": 1 if tag == "b_topk_sparse" else 0,
                 "kd_loss": 0, "kd_loss_bwd": 0, "flash_attention": 0,
                 "ssd_scan": 0}
    return {name: rounds * n for name, n in per_round.items()}


def expected_downlink_bytes(fed, transport, waves):
    """Measured downlink bytes of the dispatch waves ``(version, picks)``
    under `fed`, in dispatch order, recomputed from the wire sizes:
    multicast charges every client the steady payload, with version 0 of
    the delta family at the full broadcast; unicast charges fresh clients 0,
    catch-ups within the resync horizon the delta payload and the rest the
    full broadcast."""
    steady, full = transport._down_nbytes, transport._down_raw
    total, last_seen = 0, {}
    for version, picks in waves:
        for c in map(int, picks):
            if not fed.downlink_unicast:
                delta_family = fed.downlink_compressor.startswith("delta")
                total += full if (version == 0 and delta_family) else steady
                continue
            last = last_seen.get(c)
            if last is None or version - last > fed.resync_horizon:
                total += full
            elif version != last:
                total += steady
            last_seen[c] = version
    return total


def max_err(got, want):
    """The largest |got - want| over lists of tensors (or of tuples of
    them), which must agree in length, shape and dtype; 0 for empty ones."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} results where {len(want)} are due")
    flat = [0.0]
    for g, p in zip(got, want):
        pairs = zip(g, p) if isinstance(g, tuple) else [(g, p)]
        for a, b in pairs:
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{a.dtype} {tuple(a.shape)} where "
                                     f"{b.dtype} {tuple(b.shape)} is due")
            if a.numel():
                flat.append((a.float() - b.float()).abs().max().item())
    return max(flat)


def sweep_kernel_checks(torch, FU, WR, CP, SR, ref, gen, resnet_shapes,
                        errs):
    """The five leaf-table wire and sweep kernels against their plain
    versions on the card, bit for bit, in fp32 and bf16: over ResNet-18's 76
    leaves stacked over K (two table groups) and over edge sweeps — an empty
    leaf, lengths off the axpy's 2048, the weighted reduce's 1024 / 2048,
    QSGD's and the threshold select's 4096 and the sparse reduce's
    8192-element tiles, a leaf whose pointers are not 16-byte aligned (the
    scalar path), k = 0, out-of-range indices, duplicate indices within and
    across clients; for QSGD also against one-leaf calls with the scales
    given, with an all-zero leaf, a NaN and a -0.0; the select also over 65
    leaves."""
    dev = "cuda"

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen).to(dev, dtype)
    r_stacked = [(K,) + tuple(sh) for sh in resnet_shapes]
    edge = [(K, 0), (K, 1), (K, 3, 5, 7), (K, 1023), (K, 1025), (K, 2047),
            (K, 2049), (K, 4097)]
    w = torch.rand(K, generator=gen).to(dev)
    for dtype in (torch.float32, torch.bfloat16):
        for tag, shapes in (("resnet18", r_stacked), ("edge", edge)):
            xs = [rnd(sh, dtype) for sh in shapes]
            ys = [rnd(sh, dtype) for sh in shapes]
            if tag == "edge":   # views one element past an aligned start
                xs.append(rnd(K * 2049 + 1, dtype)[1:].view(K, 2049))
                ys.append(rnd(K * 2049 + 1, dtype)[1:].view(K, 2049))
            for name, got, want in (
                    ("fused_axpy", FU.fused_axpy_leaves(xs, ys, -0.05),
                     [ref.fused_axpy(x, y, -0.05) for x, y in zip(xs, ys)]),
                    ("weighted_reduce", WR.weighted_reduce_leaves(xs, w),
                     [ref.weighted_delta_reduce(x, w) for x in xs])):
                e = max_err(got, want)
                torch.cuda.synchronize()
                log(f"check {name} {dtype} sweep {tag} ({len(xs)} leaves): "
                    f"max |kernel - plain| = {e}")
                if e != 0.0:
                    raise AssertionError(f"{name} {dtype} {tag} sweep "
                                         f"differs from its plain version")
                errs[name] = max(errs[name], e)
            del xs, ys
    # QSGD's table against one-leaf calls (CP.qsgd, a table of one with the
    # scales given) and the plain version, the scales computed in the call
    # and by torch.amax: NaN-aware bit for bit
    # (a row holding a NaN is NaN throughout on every side)
    def same(a, b):
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(a.nan_to_num(), b.nan_to_num()))
    for dtype in (torch.float32, torch.bfloat16):
        for tag, shapes in (("resnet18", r_stacked),
                            ("edge", [sh for sh in edge if sh[1]]
                             + [(K, 0)])):
            vs = [rnd(sh, dtype) for sh in shapes]
            us = [torch.rand(sh, generator=gen).to(dev, dtype)
                  for sh in shapes]
            if tag == "edge":   # an all-zero leaf, a NaN, a -0.0
                vs[0].zero_()
                vs[1][3, 0, 0, 0] = float("nan")
                vs[2][1, 0] = -0.0
            qs, rs = CP.qsgd_leaves(vs, us, 15)
            bad = 0
            for v, u, q, r in zip(vs, us, qs, rs):
                if not v.numel():
                    continue
                sc = torch.amax(v.reshape(K, -1).abs(), dim=1)
                for want in (CP.qsgd(v, u, sc, 15),
                             ref.qsgd_quantize(v, u, sc, 15)):
                    bad += not (same(q, want[0]) and same(r, want[1]))
            torch.cuda.synchronize()
            log(f"check qsgd {dtype} sweep {tag} ({len(shapes)} leaves): "
                f"{bad} leaves differ from one-leaf calls or the plain "
                f"version")
            if bad:
                raise AssertionError(f"qsgd {dtype} {tag} sweep differs")
            del vs, us, qs, rs
    # the threshold select's table (one fp32 τ a row of every leaf) against
    # the plain version leaf by leaf, also over 65 leaves (a full group, then
    # one of one leaf), and a view one element past an aligned start
    sixty_five = [(K, 1 + 37 * i) for i in range(65)]
    for dtype in (torch.float32, torch.bfloat16):
        for tag, shapes in (("resnet18", r_stacked), ("65 leaves", sixty_five),
                            ("edge", edge + [(K,)])):
            vs = [rnd(sh, dtype) for sh in shapes]
            if tag == "edge":
                vs.append(rnd(K * 4097 + 1, dtype)[1:].view(K, 4097))
            taus = [torch.topk(v.reshape(K, -1).abs(),
                               topk_k(v[0].numel()), dim=1).values[:, -1]
                    if v[0].numel() else torch.zeros(K, device=dev,
                                                     dtype=dtype)
                    for v in vs]
            got = list(zip(*CP.threshold_select_leaves(
                vs, torch.cat(taus).float())))
            e = max_err(got, [ref.topk_threshold_select(v, t)
                              for v, t in zip(vs, taus)])
            torch.cuda.synchronize()
            log(f"check threshold_select {dtype} sweep {tag} ({len(vs)} "
                f"leaves): max |kernel - plain| = {e}")
            if e != 0.0:
                raise AssertionError(f"threshold_select {dtype} {tag} sweep "
                                     f"differs from its plain version")
            errs["threshold_select"] = max(errs["threshold_select"], e)
            del vs, taus, got
    # (n, k, index draw): unique top-k-like, or random with duplicates and
    # out-of-range indices
    r_wire = [(math.prod(sh), topk_k(math.prod(sh)), "unique")
              for sh in resnet_shapes]
    edge_wire = [(0, 0, "unique"), (5000, 0, "unique"), (1, 1, "unique"),
                 (8193, 820, "unique"), (100_003, 10_001, "unique"),
                 (997, 4096, "dups"), (3000, 400, "out-of-range"),
                 (20_000, 9000, "dups")]
    for vdt, odt in ((torch.float32, torch.float32),
                     (torch.bfloat16, torch.bfloat16),
                     (torch.bfloat16, torch.float32)):
        for tag, spec in (("resnet18", r_wire), ("edge", edge_wire)):
            vals, idxs = [], []
            for n, k, draw in spec:
                vals.append(rnd((K, k), vdt))
                if draw == "unique":
                    idx = torch.stack([torch.randperm(n, generator=gen)[:k]
                                       for _ in range(K)]) if k else \
                        torch.zeros((K, 0), dtype=torch.int64)
                elif draw == "dups":
                    idx = torch.randint(0, n, (K, k), generator=gen)
                else:
                    idx = torch.randint(-50, n + 50, (K, k), generator=gen)
                    idx[0, :2] = torch.tensor([-2 ** 31, 2 ** 31 - 1])
                idxs.append(idx.to(dev, torch.int32))
            shapes = [(n,) for n, _, _ in spec]
            got = SR.sparse_reduce_leaves(vals, idxs, w, shapes, odt)
            want = [ref.sparse_weighted_delta_reduce(v, i, w, sh, odt)
                    for v, i, sh in zip(vals, idxs, shapes)]
            e = max_err(got, want)
            torch.cuda.synchronize()
            log(f"check sparse_reduce {vdt}->{odt} sweep {tag} "
                f"({len(spec)} leaves, {sum(K * k for _, k, _ in spec)} "
                f"pairs): max |kernel - plain| = {e}")
            if e != 0.0:
                raise AssertionError(f"sparse_reduce {vdt}->{odt} {tag} "
                                     f"sweep differs from its plain version")
            errs["sparse_reduce"] = max(errs["sparse_reduce"], e)


def update_kernel_checks(torch, FU, ref, gen, resnet_shapes, errs):
    """The local and server update tables against their plain versions on
    the card, bit for bit, θ in fp32 and bf16 beside the fp32 momentum, the
    server's Δ in θ's dtype and in fp32 with the scale 1/η folded in and
    with scale 1: over ResNet-18's 76 leaves (two table groups), 65 leaves
    (a full group, then one of one leaf) and an edge sweep (an empty leaf,
    lengths off the 2048-element tile, a leaf whose pointers are not
    16-byte aligned: the scalar path)."""
    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen).to("cuda", dtype)
    edge = [(0,), (1,), (3, 5, 7), (1023,), (2047,), (2048,), (2049,),
            (4097,), (K, 2049)]
    sixty_five = [(1 + 37 * i,) for i in range(65)]
    for dtype in (torch.float32, torch.bfloat16):
        for tag, shapes in (("resnet18", resnet_shapes),
                            ("65 leaves", sixty_five), ("edge", edge)):
            th, gs, mb = ([rnd(sh, dtype) for sh in shapes] for _ in range(3))
            m = [rnd(sh, torch.float32) for sh in shapes]
            if tag == "edge":   # views one element past an aligned start
                for leaves, dt in ((th, dtype), (gs, dtype),
                                   (m, torch.float32)):
                    leaves.append(rnd(2049 + 1, dt)[1:])
                mb.append(rnd(2049, dtype))
            checks = [("local_update", "",
                       FU.local_update_leaves(th, gs, mb, ETA),
                       [ref.fedadc_local_update(t, g, b, ETA)
                        for t, g, b in zip(th, gs, mb)])]
            for ddt in (dtype, torch.float32):
                ds = [rnd(tuple(t.shape), ddt) for t in th]
                for sc in (1 / ETA, 1.0):
                    checks.append((
                        "server_update", f", delta {ddt}, scale {sc}",
                        list(zip(*FU.server_update_leaves(th, m, ds, 0.2,
                                                          0.05, sc))),
                        [ref.fedadc_server_update(t, mi, d, 0.2, 0.05, sc)
                         for t, mi, d in zip(th, m, ds)]))
            for name, what, got, want in checks:
                e = max_err(got, want)
                torch.cuda.synchronize()
                log(f"check {name} theta {dtype}{what} sweep {tag} "
                    f"({len(th)} leaves): max |kernel - plain| = {e}")
                if e != 0.0:
                    raise AssertionError(f"{name} {dtype}{what} {tag} sweep "
                                         f"differs from its plain version")
                errs[name] = max(errs[name], e)


def kd_edge_shapes(KD, esize):
    """(rows, classes, groups of ρ) at each route's boundary of the KD
    forward: the register route's cap and one more (the first cluster
    route shape), the largest C one CTA stages and one more (a cluster of
    two), for logits of `esize` bytes; and at the backward's: C one under
    and one over its tile (whole rows a tile; two chunks a row), 3 classes
    (rows off a 16-byte boundary, many a tile) and an LM vocabulary over 8
    rows (256 tiles)."""
    single = KD.SLICE_BYTES // (2 * esize)
    assert KD.cluster_plan(single, esize)[0] == 1
    assert KD.cluster_plan(single + 1, esize)[0] == 2
    tile = KD.BWD_TILE
    assert not KD.bwd_plan(64, tile - 1)[2] and KD.bwd_plan(64, tile + 1)[2]
    top = KD.max_classes(esize)
    assert KD.fwd_plan(16, top, esize)[0] == "cluster"
    assert KD.fwd_plan(16, top + 1, esize)[0] == "split"
    return [(64, KD.WARP_MAX_C, 4), (64, KD.WARP_MAX_C + 1, 4),
            (16, single, 2), (16, single + 1, 2), (64, tile - 1, 4),
            (64, tile + 1, 4), (300, 3, 3), (8, 32768, 1),
            # the cluster route's last C and the split route's first, Gemma's
            # vocabulary, and (bf16) a row of 600,000 classes
            (16, top, 2), (16, top + 1, 2), (64, 256000, 4)] + (
                [(8, 600000, 1)] if esize == 2 else [])


def bwd_excess(torch, ds, want):
    """The backward's error against its plain version: inf unless NaN and
    ±inf sit where the plain version has them, else max |kernel - plain|
    over the finite entries as a share of their largest magnitude."""
    a, b = ds.float(), want.float()
    fin = torch.isfinite(b)
    if not (torch.equal(a.isnan(), b.isnan())
            and torch.equal(a[~fin & ~b.isnan()], b[~fin & ~b.isnan()])):
        return float("inf")
    if not fin.any():
        return 0.0
    return ((a[fin] - b[fin]).abs().max() / b[fin].abs().max()).item()


def kd_bwd_check(torch, KD, ref, operands, stats, tau):
    """(max |kernel - plain|, its share of the gradient's largest magnitude
    or inf, bit for bit?) of the KD backward on the card against
    ref.kd_loss_bwd, both from the same statistics."""
    s_, t_, y_, rho_, g_ = operands
    ds = KD.kd_loss_bwd(s_, t_, y_, rho_, stats, g_, KD_LAM, tau)
    want = ref.kd_loss_bwd(s_, t_, y_, rho_, stats, g_, KD_LAM, tau)
    bits = torch.int16 if ds.dtype is torch.bfloat16 else torch.int32
    return (max_err([ds], [want]), bwd_excess(torch, ds, want),
            torch.equal(ds.view(bits), want.view(bits)))


def kd_special_rows(torch, KD, ref, gen, n_classes, dtype):
    """The KD pair on 8 rows (2 groups of ρ) holding a label out of
    range (row 0: NaN loss, CE, KL, true mass and S, the kernel's contract),
    a teacher -inf on the classes that some lanes' registers or the first
    CTA's slice hold alone (row 1), a teacher +inf and -inf (row 2), a
    student -inf on the same classes (row 3) and a student +inf (row 4) ->
    (the forward's largest excess of |kernel - plain| over 1e-5 + 1e-4
    |plain| on the finite entries, or inf where NaN or inf entries
    disagree; the backward's bwd_excess at τ = KD_TAU and KD_TAU_GENERAL,
    each from the forward's statistics at that τ).  The plain version's CE
    gathers s_y by a one-hot product, whose 0·inf is NaN on rows 3 and 4:
    there CE = lse_s - s_y and the loss follow from it."""
    s_, t_, y_, rho_, g_ = kd_operands(torch, 8, n_classes, 2, dtype, gen)
    j = torch.arange(n_classes, device="cuda")
    esize = torch.empty((), dtype=dtype).element_size()
    if n_classes <= 32:                  # lanes below C/2
        dead = j < n_classes // 2
    elif n_classes <= KD.WARP_MAX_C:     # lanes 0-15 of each row
        dead = j % 32 < 16
    elif KD.fwd_plan(8, n_classes, esize)[0] == "split":   # the first CTA's
        dead = j < KD.SPLIT_SLICE
    else:                                # the first CTA's slice
        cl, slice_, _ = KD.cluster_plan(
            n_classes, torch.empty((), dtype=dtype).element_size())
        dead = j < (slice_ if cl > 1 else n_classes // 2)
    y_[0], y_[2], y_[3], y_[4] = n_classes, 0, n_classes - 1, n_classes - 1
    t_[1, dead] = float("-inf")
    t_[2, 3], t_[2, 5] = float("inf"), float("-inf")
    s_[3, dead] = float("-inf")
    s_[4, 1] = float("inf")
    got = KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)
    want = [w.clone() for w in ref.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)]
    for r in (3, 4):
        want[1][r] = want[3][r, 0] - s_[r, y_[r]].float()
        want[0][r] = (1 - KD_LAM) * want[1][r] + KD_LAM * want[2][r]
    for w in want[:3]:
        w[0] = float("nan")
    want[3][0, 3:] = float("nan")
    worst = 0.0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        fin = torch.isfinite(b)
        if not (torch.equal(a.isnan(), b.isnan())
                and torch.equal(a[~fin & ~b.isnan()], b[~fin & ~b.isnan()])):
            worst = float("inf")
            break
        if fin.any():
            worst = max(worst, ((a[fin] - b[fin]).abs()
                                - 1e-4 * b[fin].abs()).max().item())
    bwd = []
    for tau in (KD_TAU, KD_TAU_GENERAL):
        stats = (got[3] if tau == KD_TAU
                 else KD.kd_loss(s_, t_, y_, rho_, KD_LAM, tau)[3])
        bwd.append(kd_bwd_check(torch, KD, ref, (s_, t_, y_, rho_, g_),
                                stats, tau)[1])
    return worst, bwd


def kd_kernel_checks(torch, KD, ref, gen, errs, only_new=False):
    """The KD forward and backward against their plain versions on the
    card in fp32 and bf16: at KD_SHAPES and each route's boundary
    (kd_edge_shapes), forward within 1e-5 + 1e-4 |plain|; the backward,
    from the forward's statistics, at τ = KD_TAU (its route without the
    third exp) and KD_TAU_GENERAL, within 1e-5 of the gradient's largest
    magnitude (it rounds as the plain version does, so it is logged bit for
    bit or not; each row's statistics are reduced in another order than
    the plain version's); then both on rows with an out-of-range label and
    ±inf logits (kd_special_rows) on every route, NaN and inf where the
    plain version has them.  ``only_new``: the split route's shapes alone
    (--kernel-shapes)."""
    for dtype in (torch.float32, torch.bfloat16):
        esize = torch.empty((), dtype=dtype).element_size()
        shapes = KD_SHAPES + kd_edge_shapes(KD, esize)
        specials = (10, KD.WARP_MAX_C, KD.WARP_MAX_C + 1,
                    kd_edge_shapes(KD, esize)[3][1], 32768,
                    KD.max_classes(esize) + 1)
        if only_new:
            shapes = kd_edge_shapes(KD, esize)[8:]
            specials = specials[-1:]
        for rows, n_classes, groups in shapes:
            ops_ = kd_operands(torch, rows, n_classes, groups, dtype, gen)
            s_, t_, y_, rho_, _ = ops_
            before = KD.kd_loss.launches
            got = KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)
            if KD.kd_loss.launches - before != 1:
                raise AssertionError(f"kd_loss ({rows}, {n_classes}): "
                                     f"{KD.kd_loss.launches - before} launches")
            want = ref.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)
            e = max_err([got], [want])
            excess = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                         for a, b in zip(got, want))
            stats_general = KD.kd_loss(s_, t_, y_, rho_, KD_LAM,
                                       KD_TAU_GENERAL)[3]
            bwd = [kd_bwd_check(torch, KD, ref, ops_, got[3], KD_TAU),
                   kd_bwd_check(torch, KD, ref, ops_, stats_general,
                                KD_TAU_GENERAL)]
            torch.cuda.synchronize()
            log(f"check kd_loss {dtype} ({rows}, {n_classes}) G={groups}: max "
                f"|kernel - plain| = {e} (bar 1e-5 + 1e-4 |plain|, excess "
                f"over rtol {excess}); kd_loss_bwd tau={KD_TAU}: max |kernel "
                f"- plain| = {bwd[0][0]}, {bwd[0][1]} of the largest (bar "
                f"1e-5), bit for bit {bwd[0][2]}; tau={KD_TAU_GENERAL}: "
                f"{bwd[1][0]}, {bwd[1][1]} of the largest, bit for bit "
                f"{bwd[1][2]}")
            if not (excess <= 1e-5 and all(b[1] <= 1e-5 for b in bwd)):
                raise AssertionError(f"kd kernels {dtype} ({rows}, "
                                     f"{n_classes}): differ from plain")
            errs["kd_loss"] = max(errs["kd_loss"], e)
            errs["kd_loss_bwd"] = max(errs["kd_loss_bwd"], bwd[0][0],
                                      bwd[1][0])
        for n_classes in specials:
            excess, bwd = kd_special_rows(torch, KD, ref, gen, n_classes,
                                          dtype)
            torch.cuda.synchronize()
            log(f"check kd_loss {dtype} C={n_classes} with an out-of-range "
                f"label and ±inf logits: NaN and inf where the plain version "
                f"has them, excess over 1e-5 + 1e-4 |plain| elsewhere "
                f"{excess}; kd_loss_bwd at tau={KD_TAU} and "
                f"{KD_TAU_GENERAL}: NaN and inf where the plain version has "
                f"them, share of the largest elsewhere {bwd} (bar 1e-5)")
            if not (excess <= 1e-5 and all(b <= 1e-5 for b in bwd)):
                raise AssertionError(f"kd_loss {dtype} C={n_classes}: special "
                                     f"rows differ from plain")


def leaf_shapes(params):
    from repro_torch.core.tree import leaves
    return [tuple(t.shape) for t in leaves(params)]


# -- the LM kernels (flash attention, SSD scan) and the serve phase ---------
# check shapes: flash (B, H, Hk, L, D, window) — the reference sweep
# (tests/test_kernels.py:23-53), zamba2-1.2b's prefill and Qwen3's heads
FLASH_SHAPES = [(1, 2, 2, 128, 64, 0), (2, 4, 2, 256, 64, 0),
                (1, 8, 1, 128, 128, 0), (1, 4, 4, 192, 64, 0),
                (1, 2, 2, 256, 64, 32), (1, 2, 2, 256, 64, 64),
                (1, 2, 2, 256, 64, 128), (4, 32, 32, 2048, 64, 0),
                (1, 32, 8, 1024, 128, 0),
                # phase 14's heads: internvl2-26b (48 over 8, a group of
                # 6) and llama4-scout (40 over 8, a group of 5)
                (1, 48, 8, 2048, 128, 0), (2, 40, 8, 2048, 128, 0)]
# every head dim: Phi-2 (D 80), Phi-3-mini (96), Gemma-7B (256), a GQA
# window at D 256, an odd D padded (40), and D above 256 (the wide route)
FLASH_NEW_SHAPES = [(1, 32, 32, 2048, 80, 0), (1, 32, 32, 4096, 96, 0),
                    (1, 16, 16, 4096, 256, 0), (1, 8, 2, 1024, 256, 256),
                    (2, 4, 2, 192, 40, 0), (1, 4, 4, 256, 320, 0),
                    (1, 2, 1, 128, 512, 0)]
FLASH_SHAPES += FLASH_NEW_SHAPES
# SSD (b, L, H, P, N, chunk) — the reference sweep (:78-93), ragged lengths
# (L 300; L 1100, five chunks), batch 1 at L 4096 (the carry crosses 16
# chunks), P 12 and N 10 (the kernels' element-by-element copies) and
# zamba2-1.2b's prefill (last: the timed shape)
# every P, N and chunk: Mamba-2 2.7B's layer (arXiv:2405.21060: d_model
# 2560, expand 2, head dim 64, d_state 128), N 128 and P 128 on a ragged L,
# slices of both (P 160, N 192), chunks above 256
SSD_NEW_SHAPES = [(1, 4096, 80, 64, 128, 256), (2, 1100, 4, 128, 128, 256),
                  (1, 512, 2, 160, 192, 128), (1, 2048, 4, 64, 64, 512),
                  (1, 1000, 2, 32, 16, 1000)]
SSD_SHAPES = [(1, 64, 2, 16, 8, 16), (2, 128, 4, 32, 16, 32),
              (1, 256, 2, 64, 64, 64), (2, 96, 3, 16, 8, 32),
              (1, 300, 4, 64, 64, 256), (1, 1100, 4, 64, 64, 256),
              (1, 4096, 2, 64, 64, 256), (1, 64, 2, 12, 10, 16),
              *SSD_NEW_SHAPES, (4, 2048, 64, 64, 64, 256)]
# decays whose exp(a_end) underflows to 0, at N 64 and at N 128
SSD_UNDERFLOW = {"underflow": (1, 1024, 4, 64, 64, 256),
                 "underflow128": (1, 1024, 4, 64, 128, 256)}
FLASH_BAR = {"float32": 2e-5, "bfloat16": 2e-2}   # abs and rel, :38-53
SSD_BAR = {"float32": 2e-5, "bfloat16": 5e-2}     # of max |y|, :89-93
SSD_SPLIT_BAR = 1e-4      # of max |y|: bf16 B, C with an fp32 output
ZAMBA = "zamba2-1.2b"
SERVE_B, SERVE_L, LONG_L = 4, 2048, 32768


def visible_pairs(L, window):
    """(query, key) pairs the causal mask, and the window, leave."""
    if window <= 0:
        return L * (L + 1) // 2
    return sum(min(q + 1, window) for q in range(L))


def flash_bound(B, H, Hk, L, D, window, elem_bytes):
    """(bound_ms, bound_by, flops): 4·D flops per visible pair per (batch,
    head) against fp32's or bf16's peak, q, k, v read and o written once
    against HBM."""
    flops = 4 * B * H * D * visible_pairs(L, window)
    nbytes = elem_bytes * B * L * D * (2 * H + 2 * Hk)
    rate = FP32_FLOP_PER_S if elem_bytes == 4 else BF16_FLOP_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops


def ssd_bound(b, L, H, P, N, chunk, elem_bytes):
    """(bound_ms, bound_by, flops) of one SSD scan: per (batch, head,
    chunk of q positions) the causal scores and their product with x,
    (q² + q)(N + P), the carried term and the state update, 4qNP; x·dt
    and a read in fp32, B, C and y in the working type, against HBM."""
    Q = min(chunk, L)
    flops = 0
    for c0 in range(0, L, Q):
        q = min(Q, L - c0)
        flops += (q * q + q) * (N + P) + 4 * q * N * P
    flops *= b * H
    nbytes = b * L * H * (4 * P + 4 + elem_bytes * (2 * N + P))
    rate = FP32_FLOP_PER_S if elem_bytes == 4 else BF16_FLOP_PER_S
    t_ops, t_bytes = flops / rate * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("bytes" if t_bytes >= t_ops
                                 else "operations"), flops


def flash_operands(torch, shape, dtype, gen):
    B, H, Hk, L, D, _ = shape
    return (torch.randn(B, L, H, D, generator=gen).to("cuda", dtype),
            torch.randn(B, L, Hk, D, generator=gen).to("cuda", dtype),
            torch.randn(B, L, Hk, D, generator=gen).to("cuda", dtype))


def ssd_operands(torch, shape, dtype, gen, dt_scale=1.0):
    """The kernel's pre-gated operands (x·dt, the log decay, B, C) from a
    Mamba2-like draw: dt = dt_scale·softplus(N(0, 1)), A_log = log(1..H)."""
    from repro_torch.kernels import ref
    b, L, H, P, N, _ = shape
    x = torch.randn(b, L, H, P, generator=gen).to("cuda", dtype)
    dt = dt_scale * torch.nn.functional.softplus(
        torch.randn(b, L, H, generator=gen))
    A_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32))
    xdt, a = ref.ssd_prologue(x, dt.cuda(), A_log.cuda())
    Bm, Cm = (torch.randn(b, L, H, N, generator=gen).to("cuda", dtype)
              for _ in range(2))
    return xdt, a, Bm, Cm


def lm_kernel_checks(torch, FA, SSD, ref, gen, errs, flash_shapes=None,
                     ssd_shapes=None):
    """Hold flash attention and the SSD scan against their plain versions
    on the card at FLASH_SHAPES and SSD_SHAPES (or the shapes given), fp32
    and bf16, at the reference's bars, each call's launches against its
    plan's; record each kernel's largest absolute error."""
    if flash_shapes is None:
        flash_shapes = FLASH_SHAPES
    if ssd_shapes is None:
        ssd_shapes = SSD_SHAPES + list(SSD_UNDERFLOW)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).replace("torch.", "")
        for shape in flash_shapes:
            q, k, v = flash_operands(torch, shape, dtype, gen)
            before = FA.flash_attention.launches
            got = FA.flash_attention(q, k, v, True, shape[5])
            pl = FA.plan(shape[4], dtype)
            if FA.flash_attention.launches - before != pl["launches"]:
                raise AssertionError(f"flash_attention {name} {shape}: "
                                     f"{FA.flash_attention.launches - before}"
                                     f" launches, the plan {pl['launches']}")
            want = ref.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                       v.transpose(1, 2), True,
                                       shape[5]).transpose(1, 2)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            excess = (diff - FLASH_BAR[name] * want.float().abs()).max()
            log(f"check flash_attention {name} (B, H, Hk, L, D, window) "
                f"{shape}: max |kernel - plain| = {diff.max().item()} (bar "
                f"{FLASH_BAR[name]} abs + rel, excess {excess.item()}); "
                f"route {pl['route']} {pl['template']}, "
                f"{pl['launches']} launch(es)")
            if not excess.item() <= FLASH_BAR[name]:
                raise AssertionError(f"flash_attention {name} {shape}: "
                                     f"kernel differs from plain")
            errs["flash_attention"] = max(errs["flash_attention"],
                                          diff.max().item())
            del q, k, v, got, want, diff
        for shape in ssd_shapes:
            if shape in SSD_UNDERFLOW:    # exp(a_end) underflows to 0
                shape = SSD_UNDERFLOW[shape]
                xdt, a, Bm, Cm = ssd_operands(torch, shape, dtype, gen,
                                              dt_scale=40.0)
            else:
                xdt, a, Bm, Cm = ssd_operands(torch, shape, dtype, gen)
            Q = min(shape[5], shape[1])
            before = SSD.ssd_scan.launches
            got, acum, state = SSD.ssd_scan(xdt, a, Bm, Cm, Q, dtype,
                                            intermediates=True)
            if SSD.ssd_scan.launches - before != 1:
                raise AssertionError(f"ssd_scan {name} {shape}: "
                                     f"{SSD.ssd_scan.launches - before} "
                                     f"launches")
            want32 = ref.ssd_recurrence(xdt, a, Bm, Cm)
            want = want32.to(dtype).float()
            # bf16 B and C with an fp32 output: the tensor cores' products
            # on split (hi + lo) operands stay within SSD_SPLIT_BAR, which a
            # single bf16 rounding of the scores or of x would miss
            rel32 = 0.0
            if dtype == torch.bfloat16:
                got32 = SSD.ssd_scan(xdt, a, Bm, Cm, Q, torch.float32)
                rel32 = ((got32 - want32).abs().max()
                         / want32.abs().max()).item()
                del got32
            # what the kernels left in device memory against the plain
            # phases: the running sums (double) and the state before each
            # chunk (the chunk states themselves are overwritten in place)
            r_acum, r_S = ref.ssd_chunk_states(xdt, a, Bm, Q)
            r_h = ref.ssd_state_pass(r_S, r_acum)
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            rel = err / want.abs().max().item()
            e_acum = (acum[..., :Q] - r_acum).abs().max().item()
            N, P = shape[4], shape[3]
            e_h = ((state[..., :N, :P] - r_h).abs().max()
                   / r_h.abs().max().clamp_min(1e-30)).item()
            pad = bool(state[..., N:, :].any() or state[..., P:].any())
            log(f"check ssd_scan {name} (b, L, H, P, N, chunk) {shape}: max "
                f"|kernel - plain| = {err}, {rel} of max |y| (bar "
                f"{SSD_BAR[name]}); running sums {e_acum} (bar 1e-9), states "
                f"{e_h} of max |h| (bar 1e-4), padding nonzero {pad}"
                + (f"; fp32 output {rel32} of max |y| (bar {SSD_SPLIT_BAR})"
                   if dtype == torch.bfloat16 else ""))
            if not (rel <= SSD_BAR[name] and e_acum <= 1e-9 and e_h <= 1e-4
                    and rel32 <= SSD_SPLIT_BAR and not pad
                    and torch.isfinite(got).all()):
                raise AssertionError(f"ssd_scan {name} {shape}: kernel "
                                     f"differs from plain")
            errs["ssd_scan"] = max(errs["ssd_scan"], err)
            del xdt, a, Bm, Cm, got, want, want32, acum, state, r_acum, r_S
            del r_h
    refuse_grad_check(torch)


def refuse_grad_check(torch):
    """On the card neither LM kernel has a backward: ops refuses operands
    that need a gradient under grad mode, and runs them under no_grad."""
    from repro_torch.kernels import ops
    q = torch.randn(1, 64, 2, 64, device="cuda", requires_grad=True)
    x = torch.randn(1, 64, 2, 16, device="cuda", requires_grad=True)
    dt = torch.rand(1, 64, 2, device="cuda")
    A_log, D = torch.zeros(2, device="cuda"), torch.ones(2, device="cuda")
    Bm = torch.randn(1, 64, 2, 8, device="cuda")
    calls = {"flash_attention": lambda: ops.flash_attention(q, q, q),
             "ssd_scan": lambda: ops.ssd_scan(x, dt, A_log, Bm, Bm, D, 16)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            log(f"check {name} refuses a gradient: {e}")
        else:
            raise AssertionError(f"{name}: ran under grad on operands that "
                                 f"require grad")
        with torch.no_grad():
            call()


def lm_kernel_times(torch, FA, SSD, ref, gen):
    """Time both kernels, their plain versions and (flash) the library's
    scaled_dot_product_attention at zamba2-1.2b's prefill shapes in fp32
    -> the `kernels` line's records; then log the prefill_32k shape."""
    F = torch.nn.functional
    timed = {}
    fshape = FLASH_SHAPES[7]
    q, k, v = flash_operands(torch, fshape, torch.float32, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by, flops = flash_bound(*fshape, elem_bytes=4)
    timed["flash_attention"] = {
        "ms": cuda_ms(torch, lambda: FA.flash_attention(q, k, v, True, 0)),
        "plain_ms": cuda_ms(torch, lambda: ref.flash_attention(
            qt, kt, vt, True, 0)),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
        "bound_ms": b_ms, "bound_by": b_by}
    log(f"time flash_attention {fshape} fp32 ({flops:.4g} flops): "
        f"{json.dumps(timed['flash_attention'])}")
    del q, k, v, qt, kt, vt
    # the same shape in bf16, on the tensor cores
    q, k, v = flash_operands(torch, fshape, torch.bfloat16, gen)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    b_ms, b_by, flops = flash_bound(*fshape, elem_bytes=2)
    rec = {"ms": cuda_ms(torch, lambda: FA.flash_attention(q, k, v, True, 0)),
           "plain_ms": cuda_ms(torch, lambda: ref.flash_attention(
               qt, kt, vt, True, 0)),
           "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
               qt, kt, vt, is_causal=True, enable_gqa=True)),
           "bound_ms": b_ms, "bound_by": b_by}
    log(f"time flash_attention {fshape} bf16 ({flops:.4g} flops): "
        f"{json.dumps(rec)}")
    del q, k, v, qt, kt, vt
    sshape = SSD_SHAPES[-1]
    xdt, a, Bm, Cm = ssd_operands(torch, sshape, torch.float32, gen)
    b_ms, b_by, flops = ssd_bound(*sshape, elem_bytes=4)
    timed["ssd_scan"] = {
        "ms": cuda_ms(torch, lambda: SSD.ssd_scan(xdt, a, Bm, Cm, 256,
                                                  torch.float32)),
        "plain_ms": cuda_ms(torch, lambda: ref.ssd_recurrence(xdt, a, Bm, Cm),
                            iters=3, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log(f"time ssd_scan {sshape} fp32 ({flops:.4g} flops): "
        f"{json.dumps(timed['ssd_scan'])}")
    log(f"time ssd_scan {sshape} fp32, device ms by kernel (three a call): "
        f"{json.dumps(device_ms_by_kernel(torch, lambda: SSD.ssd_scan(xdt, a, Bm, Cm, 256, torch.float32)))}")
    del xdt, a, Bm, Cm
    # the same shape with B, C and y in bf16, on the tensor cores (row 10b)
    xdt, a, Bm, Cm = ssd_operands(torch, sshape, torch.bfloat16, gen)
    b_ms, b_by, flops = ssd_bound(*sshape, elem_bytes=2)
    rec = {"ms": cuda_ms(torch, lambda: SSD.ssd_scan(xdt, a, Bm, Cm, 256,
                                                     torch.bfloat16)),
           "plain_ms": cuda_ms(torch, lambda: ref.ssd_recurrence(
               xdt, a, Bm, Cm), iters=3, warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    log(f"time ssd_scan {sshape} bf16 ({flops:.4g} flops): "
        f"{json.dumps(rec)}; device ms by kernel: "
        f"{json.dumps(device_ms_by_kernel(torch, lambda: SSD.ssd_scan(xdt, a, Bm, Cm, 256, torch.bfloat16)))}")
    del xdt, a, Bm, Cm
    # the prefill_32k shape (batch 1): the plain flash attention would need
    # the (L, L) scores, 137 GB, so only the kernel and the library
    for dtype, eb in ((torch.float32, 4), (torch.bfloat16, 2)):
        lshape = (1, 32, 32, LONG_L, 64, 0)
        q, k, v = flash_operands(torch, lshape, dtype, gen)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        b_ms, b_by, flops = flash_bound(*lshape, elem_bytes=eb)
        log(f"time flash_attention {lshape} {dtype}: ms="
            f"{cuda_ms(torch, lambda: FA.flash_attention(q, k, v), 3, 1)} "
            f"library_ms={cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True), 3, 1)} "
            f"bound_ms={b_ms} ({b_by}, {flops:.4g} flops)")
        del q, k, v, qt, kt, vt
        sshape = (1, LONG_L, 64, 64, 64, 256)
        xdt, a, Bm, Cm = ssd_operands(torch, sshape, dtype, gen)
        b_ms, b_by, flops = ssd_bound(*sshape, elem_bytes=eb)
        plain = cuda_ms(torch, lambda: ref.ssd_recurrence(xdt, a, Bm, Cm),
                        1, 0) if dtype == torch.float32 else None
        log(f"time ssd_scan {sshape} {dtype}: ms="
            f"{cuda_ms(torch, lambda: SSD.ssd_scan(xdt, a, Bm, Cm, 256, dtype), 3, 1)} "
            f"plain_ms={plain} bound_ms={b_ms} ({b_by}, {flops:.4g} flops)")
        del xdt, a, Bm, Cm
    return timed


# -- every shape the reference's kernels take ------------------------------
# sparse leaves (elements, top-k fraction): the old one-segment limit + 1,
# zamba2-1.2b's embedding, and 2**30 + 3 (at 1%, so that the plain
# version's memory stays in bounds); K clients
SPARSE_NEW_LEAVES = [(3350 * 8192 + 1, 0.1), (65536000, 0.1),
                     (2 ** 30 + 3, 0.01)]
SPARSE_NEW_K = 4
SPARSE_ZAMBA_FRAC = 0.1
# the model path: zamba2-1.2b with Mamba-2's own state size, cut to 2
# layers, at B 1 x L 2048
DSTATE_LAYERS, DSTATE_B, DSTATE_L = 2, 1, 2048


def sparse_bound(n, pairs, vbytes, obytes):
    """(bound_ms, bound_by) of one sparse reduce of `pairs` (value of
    `vbytes` + 4-byte index) into a leaf of n elements of `obytes`: one
    multiply and one add a pair."""
    t_bytes = (pairs * (vbytes + 4) + n * obytes) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * pairs / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def unique_draw(torch, n, k, clients, gen):
    """(clients, k) int32 indices into [0, n), each row without repeats (a
    top-k wire's), drawn on the card: a random order of k strata of n // k
    elements, one element of each."""
    w = n // k
    rows = [torch.randperm(k, generator=gen, device="cuda") * w
            + torch.randint(0, w, (k,), generator=gen, device="cuda")
            for _ in range(clients)]
    return torch.stack(rows).to(torch.int32)


def sparse_wire(torch, n, frac, dtype, gen):
    """K top-k-like (values, indices) wires of one leaf and the weights."""
    k = max(1, math.ceil(frac * n))
    idx = unique_draw(torch, n, k, SPARSE_NEW_K, gen)
    vals = torch.randn((SPARSE_NEW_K, k), generator=gen, device="cuda").to(
        dtype)
    w = torch.rand(SPARSE_NEW_K, generator=gen, device="cuda") * 0.8 + 0.2
    return vals, idx, w


def shapes_phase(torch, np, gen, errs):
    """Every shape the reference's Pallas kernels take, on the card (the
    flash, SSD and KD shapes are checked in lm_kernel_checks and
    kd_kernel_checks): (a) the sparse reduce on leaves that need segments,
    fp32 and bf16, bit for bit against its plain version, one launch a
    call; (b) aggregation.sparse_weighted_mean over zamba2-1.2b's 74 leaves
    with K 4 top-k 10% wires, bit for bit; (c) each new shape of the four
    kernels timed by cuda_ms beside its bound (flash also beside
    scaled_dot_product_attention); (d) zamba2-1.2b with d_state 128
    at 2 layers, B 1 x L 2048: the kernel route against the plain route,
    fp32 and bf16, within the serve phase's bars, one ssd_scan a Mamba2
    block, and the SSD's three kernels in the profile. -> the records of
    (c)."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.core import tree as T
    from repro_torch.federated import aggregation
    from repro_torch.federated.compression import SparseLeaf
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kd_loss as KD
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import sparse_reduce as SR
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.models.registry import get_model
    cgen = torch.Generator(device="cuda").manual_seed(27)
    records = []
    t0 = time.perf_counter()

    # (a) the sparse reduce on wide leaves
    for n, frac in SPARSE_NEW_LEAVES:
        for dtype in (torch.float32, torch.bfloat16):
            vals, idx, w = sparse_wire(torch, n, frac, dtype, cgen)
            before = SR.sparse_reduce_leaves.launches
            got = SR.sparse_reduce(vals, idx, w, (n,), dtype)
            launches = SR.sparse_reduce_leaves.launches - before
            want = ref.sparse_weighted_delta_reduce(vals, idx, w, (n,), dtype)
            torch.cuda.synchronize()
            bits = torch.int16 if dtype is torch.bfloat16 else torch.int32
            same = torch.equal(got.view(bits), want.view(bits))
            e = (got.float() - want.float()).abs().max().item()
            del want
            log(f"check sparse_reduce {dtype} one leaf of {n} elements "
                f"({len(SR.segments(n))} segments), K {SPARSE_NEW_K} x k "
                f"{vals.shape[1]}: bit for bit {same}, max |kernel - plain| "
                f"= {e}, {launches} launch")
            if not (same and launches == 1):
                raise AssertionError(f"sparse_reduce {dtype} n={n}: differs "
                                     f"from plain or launched {launches}")
            errs["sparse_reduce"] = max(errs["sparse_reduce"], e)
            b_ms, b_by = sparse_bound(n, vals.numel(), vals.element_size(),
                                      dtype.itemsize)
            rec = {"kernel": "sparse_reduce", "shape": [n, vals.shape[1]],
                   "dtype": str(dtype), "ms": cuda_ms(
                       torch, lambda: SR.sparse_reduce(vals, idx, w, (n,),
                                                       dtype)),
                   "bound_ms": b_ms, "bound_by": b_by}
            records.append(rec)
            log(f"time {json.dumps(rec)}")
            del vals, idx, w, got
            torch.cuda.empty_cache()

    log(f"shapes (a): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    # (b) the sparse aggregate over zamba2-1.2b's leaves
    zcfg = get_arch(ZAMBA)
    like = get_model(zcfg).init(0, zcfg, device="meta")
    leaves = T.leaves(like)
    for dtype in (torch.float32, torch.bfloat16):
        wire_leaves = []
        for leaf in leaves:
            n = leaf.numel()
            k = max(1, math.ceil(SPARSE_ZAMBA_FRAC * n))
            wire_leaves.append(SparseLeaf(
                torch.randn((SPARSE_NEW_K, k), generator=cgen,
                            device="cuda").to(dtype),
                unique_draw(torch, n, k, SPARSE_NEW_K, cgen)))
        order = iter(wire_leaves)
        wire = T.tree_map(lambda _leaf: next(order), like)
        like_d = T.tree_map(lambda l: torch.empty(l.shape, dtype=dtype,
                                                  device="meta"), like)
        weights = torch.rand(SPARSE_NEW_K, generator=cgen, device="cuda") + 0.5
        ops.reset_launch_counts()
        got = aggregation.sparse_weighted_mean(wire, weights, like_d)
        launches = ops.launch_counts()["sparse_reduce"]
        wn = weights.float() / torch.clamp(torch.sum(weights), min=1e-12)
        same, worst = True, 0.0
        for g_, wl, l in zip(T.leaves(got), wire_leaves, T.leaves(like_d)):
            want = ref.sparse_weighted_delta_reduce(wl.values, wl.indices, wn,
                                                    tuple(l.shape), dtype)
            bits = torch.int16 if dtype is torch.bfloat16 else torch.int32
            same &= torch.equal(g_.contiguous().view(bits), want.view(bits))
            worst = max(worst, (g_.float() - want.float()).abs().max().item())
            del want
        torch.cuda.synchronize()
        pairs = sum(w_.values.numel() for w_ in wire_leaves)
        log(f"check sparse_weighted_mean {dtype} over {ZAMBA}'s "
            f"{len(wire_leaves)} leaves ({pairs} pairs, K {SPARSE_NEW_K}, "
            f"top-k {SPARSE_ZAMBA_FRAC}): bit for bit {same}, max |kernel - "
            f"plain| = {worst}, {launches} sparse_reduce launch")
        if not (same and launches == 1):
            raise AssertionError(f"sparse_weighted_mean {dtype} over {ZAMBA}: "
                                 f"differs from plain or launched {launches}")
        del wire, wire_leaves, got
        torch.cuda.empty_cache()

    log(f"shapes (b): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    # (c) the new shapes' times
    F = torch.nn.functional
    for shape in FLASH_NEW_SHAPES:
        for dtype, eb in ((torch.float32, 4), (torch.bfloat16, 2)):
            q, k, v = flash_operands(torch, shape, dtype, gen)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            b_ms, b_by, _ = flash_bound(*shape, elem_bytes=eb)
            pl = FA.plan(shape[4], dtype)
            rec = {"kernel": "flash_attention", "shape": list(shape),
                   "dtype": str(dtype), "route": pl["route"],
                   "launches": pl["launches"],
                   "ms": cuda_ms(torch, lambda: FA.flash_attention(
                       q, k, v, True, shape[5])),
                   "library_ms": cuda_ms(
                       torch, lambda: F.scaled_dot_product_attention(
                           qt, kt, vt, attn_mask=None if not shape[5]
                           else window_mask(torch, shape[3], shape[5]),
                           is_causal=not shape[5], enable_gqa=True)),
                   "bound_ms": b_ms, "bound_by": b_by}
            records.append(rec)
            log(f"time {json.dumps(rec)}")
            del q, k, v, qt, kt, vt
    for shape in SSD_NEW_SHAPES + [SSD_UNDERFLOW["underflow128"]]:
        for dtype, eb in ((torch.float32, 4), (torch.bfloat16, 2)):
            xdt, a, Bm, Cm = ssd_operands(torch, shape, dtype, gen)
            Q = min(shape[5], shape[1])
            b_ms, b_by, _ = ssd_bound(*shape, elem_bytes=eb)
            rec = {"kernel": "ssd_scan", "shape": list(shape),
                   "dtype": str(dtype),
                   "ms": cuda_ms(torch, lambda: SSD.ssd_scan(
                       xdt, a, Bm, Cm, Q, dtype)),
                   "bound_ms": b_ms, "bound_by": b_by}
            records.append(rec)
            log(f"time {json.dumps(rec)}")
            del xdt, a, Bm, Cm
    for dtype, eb in ((torch.float32, 4), (torch.bfloat16, 2)):
        for rows, n_classes, groups in kd_edge_shapes(KD, eb)[8:]:
            s_, t_, y_, rho_, g_ = kd_operands(torch, rows, n_classes,
                                               groups, dtype, gen)
            st = KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)[3]
            rec = {"kernel": "kd_loss", "shape": [rows, n_classes, groups],
                   "dtype": str(dtype),
                   "route": KD.fwd_plan(rows, n_classes, eb)[0],
                   "ms": cuda_ms(torch, lambda: KD.kd_loss(
                       s_, t_, y_, rho_, KD_LAM, KD_TAU)),
                   "bound_ms": kd_bound("kd_loss", rows, n_classes, groups,
                                        eb)[0],
                   "bwd_ms": cuda_ms(torch, lambda: KD.kd_loss_bwd(
                       s_, t_, y_, rho_, st, g_, KD_LAM, KD_TAU)),
                   "bwd_bound_ms": kd_bound("kd_loss_bwd", rows, n_classes,
                                            groups, eb)[0]}
            records.append(rec)
            log(f"time {json.dumps(rec)}")
            del s_, t_, y_, rho_, g_, st

    log(f"shapes (c): {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    # (d) zamba2-1.2b with d_state 128, 2 layers, kernel route vs plain
    cfg = replace(zcfg, ssm=replace(zcfg.ssm, d_state=128),
                  n_layers=DSTATE_LAYERS,
                  block_pattern=zcfg.block_pattern[:DSTATE_LAYERS])
    model = get_model(cfg)
    toks = torch.from_numpy(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (DSTATE_B, DSTATE_L))).cuda()
    for dtype, bar in ((torch.float32, 1e-3), (torch.bfloat16, 5e-2)):
        params = model.init(0, cfg, dtype=dtype, device="cuda")

        def fwd(use_pallas):
            with torch.no_grad():
                return model.forward(params, {"tokens": toks}, cfg,
                                     use_pallas)[0].float()
        got = counted_forward(ops, lambda: fwd(True), DSTATE_LAYERS, 0, {
            "ssd_scan": 0, "flash_attention": 0}, tag="d_state 128")
        want = fwd(False)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fwd(True)
            torch.cuda.synchronize()
        names = [e.key for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        ssd = [k_ for k_ in ("ssd_states", "ssd_carry", "ssd_outputs")
               if any(k_ in nm for nm in names)]
        log(f"check d_state 128 {ZAMBA} {DSTATE_LAYERS} layers {dtype} B "
            f"{DSTATE_B} L {DSTATE_L}: logits {tuple(got.shape)}, max |kernel "
            f"- plain route| = {err} = {err / scale} of max |logit| {scale} "
            f"(bar {bar}); SSD kernels in the profile {ssd}")
        if not (torch.isfinite(got).all() and err <= bar * scale
                and len(ssd) == 3):
            raise AssertionError(f"d_state 128 {dtype}: the routes differ or "
                                 f"the SSD kernels did not run")
        del params, got, want
    log(f"shapes (d): {time.perf_counter() - t0:.1f}s")
    return records


def window_mask(torch, L, window):
    """The causal sliding-window mask as scaled_dot_product_attention takes
    it (True: attend)."""
    i = torch.arange(L, device="cuda")
    return (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)


def kernel_shapes_main():
    """--kernel-shapes: build, then only the checks and times of the shapes
    past the kernels' single-tile routes (kd_edge_shapes' split-route
    shapes, FLASH_NEW_SHAPES, SSD_NEW_SHAPES, shapes_phase), and one JSON
    line of the times."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kd_loss as KD
    from repro_torch.kernels import ssd_scan as SSD
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    for rec in build.build_all():
        usage = ", ".join(f"{n} {r} registers" + (f" {sp} B spilled" if sp
                                                   else "")
                          for n, r, sp in ptxas_usage(rec["log"]))
        log(f"build: {Path(rec['source']).name} built={rec['built']} "
            f"in {rec['seconds']:.1f}s; {usage}")
    gen = torch.Generator().manual_seed(0)
    errs = {name: 0.0 for name in ops.KERNELS}
    kd_kernel_checks(torch, KD, ref, gen, errs, only_new=True)
    lm_kernel_checks(torch, FA, SSD, ref, gen, errs, FLASH_NEW_SHAPES,
                     SSD_NEW_SHAPES + ["underflow128"])
    records = shapes_phase(torch, np, gen, errs)
    log(json.dumps({"card": smi, "errs": errs, "times": records,
                    "seconds": time.perf_counter() - t0}))
    return 0


def check_tokens(tag, got, want, ref_logits, bound):
    """Tokens of two routes agree wherever the reference logits' top-2
    margin exceeds `bound`; a differing token below it is logged as a
    near-tie.  -> the number of near-ties."""
    top2 = ref_logits.float().topk(2, dim=-1).values
    margin = (top2[:, 0] - top2[:, 1]).cpu()
    ties = 0
    for i, (a, b) in enumerate(zip(got.tolist(), want.tolist())):
        if a == b:
            continue
        log(f"{tag}: row {i} token {a} vs {b}, top-2 margin "
            f"{margin[i].item()} (bound {bound})")
        if margin[i].item() > bound:
            raise AssertionError(f"{tag}: tokens differ above the bound")
        ties += 1
    return ties


def counted_forward(ops, fn, n_mamba, n_attn, totals, tag="serve"):
    """Run one kernel-route forward with the counts set to 0 just before
    and read just after: exactly one ssd_scan per Mamba2 block and one
    flash_attention per attention block that takes the kernel."""
    ops.reset_launch_counts()
    out = fn()
    got = ops.launch_counts()
    if (got["ssd_scan"], got["flash_attention"]) != (n_mamba, n_attn) or \
            sum(got.values()) != n_mamba + n_attn:
        raise AssertionError(f"{tag}: one forward launched {got}, expected "
                             f"{n_mamba} ssd_scan and {n_attn} "
                             f"flash_attention")
    for k in ("ssd_scan", "flash_attention"):
        totals[k] += got[k]
    return out


def serve_phase(torch, np):
    """Zamba2-1.2B at full width on the card: (a) the prefill step on B 4 x
    L 2048 in fp32 and bf16, (b) one prefill_32k sequence, (c) the
    continuous-batching engine, (d) the card against the CPU at depth 7.
    -> the kernel launches of the kernel-route forwards of (a) and (b)."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.configs.base import MAMBA2, SHARED_ATTN
    from repro_torch.core import tree as T
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_prefill_step
    from repro_torch.models.registry import count_params, get_model
    from repro_torch.serving import (SamplingParams, SchedulerConfig,
                                     ServingEngine, latency_summary)
    cfg = get_arch(ZAMBA)
    model = get_model(cfg)
    V = cfg.vocab_size
    n_mamba = sum(k == MAMBA2 for k in cfg.blocks())
    n_attn = sum(k == SHARED_ATTN for k in cfg.blocks())
    totals = {"ssd_scan": 0, "flash_attention": 0}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(0, cfg, device="cuda")
    torch.cuda.synchronize()
    log(f"serve: {ZAMBA} at full width ({n_mamba} Mamba2 blocks, shared "
        f"attention x{n_attn}), {count_params(cfg)} parameters, fp32 init on "
        f"the card in {time.perf_counter() - t0:.2f}s; TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cudnn "
        f"{torch.backends.cudnn.allow_tf32} (library defaults; no "
        f"convolution runs through cuDNN here)")

    def last_logits(p, toks, use_pallas):
        logits, _ = model.forward(p, {"tokens": toks}, cfg, use_pallas,
                                  logits_slice="last")
        return logits[:, -1].float()

    def compare_routes(tag, p, toks, rel_bound, repeats):
        """The kernel route (prefill step, timed) against the
        use_pallas=False route: first tokens and last-position logits."""
        kernel_step = make_prefill_step(cfg, use_pallas=True)
        batch = {"tokens": toks}
        first = counted_forward(ops, lambda: kernel_step(p, batch), n_mamba,
                                n_attn, totals)
        times = []
        for _ in range(repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            counted_forward(ops, lambda: kernel_step(p, batch), n_mamba,
                            n_attn, totals)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        got = counted_forward(ops, lambda: last_logits(p, toks, True),
                              n_mamba, n_attn, totals)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = last_logits(p, toks, False)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        if not (torch.isfinite(got).all() and got.shape == (toks.shape[0],
                                                            V)):
            raise AssertionError(f"{tag}: bad logits {got.shape}")
        scale = want.abs().max().item()
        err = (got - want).abs().max().item()
        ties = check_tokens(tag, first, want.argmax(-1).int(), want,
                            rel_bound * scale)
        log(f"{tag}: prefill step (kernel route) seconds {times}, the "
            f"use_pallas=False route's forward {plain_s:.3f}s; last-position "
            f"logits max |kernel - plain route| = {err} = {err / scale} of "
            f"max |logit| {scale} (bar {rel_bound}); first tokens "
            f"{first.tolist()}, {ties} near-ties; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not err <= rel_bound * scale:
            raise AssertionError(f"{tag}: the routes' logits differ")
        return times

    # (a) B 4 x L 2048, fp32 then bf16
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, V, (SERVE_B, SERVE_L))).cuda()
    compare_routes(f"serve (a) fp32 B {SERVE_B} L {SERVE_L}", params, toks,
                   1e-3, repeats=2)
    # one profiled prefill: device time by kernel and the idle share
    step = make_prefill_step(cfg, use_pallas=True)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        counted_forward(ops, lambda: step(params, {"tokens": toks}), n_mamba,
                        n_attn, totals)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0), key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    log(f"serve profile: prefill B {SERVE_B} L {SERVE_L} fp32, kernels busy "
        f"{busy:.3f} ms of a profiled wall {wall_ms:.3f} ms (idle share "
        f"{1 - busy / wall_ms if busy else 'not measured'})")
    for key, ms, count in rows[:12]:
        log(f"serve profile:   {ms:9.3f} ms  x{count:<5} {key[:90]}")
    params_bf = model.init(0, cfg, dtype=torch.bfloat16, device="cuda")
    compare_routes(f"serve (a) bf16 B {SERVE_B} L {SERVE_L}", params_bf, toks,
                   5e-2, repeats=1)
    del params_bf

    # (b) one sequence at the prefill_32k length
    long_toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, V, (1, LONG_L))).cuda()
    compare_routes(f"serve (b) fp32 B 1 L {LONG_L}", params, long_toks, 1e-3,
                   repeats=1)
    del long_toks
    launches = dict(totals)
    log(f"serve: kernel launches of the kernel-route forwards {launches}")

    # (c) the engine: 4 slots, chunk 16, 8 requests of 32-128 tokens, 32
    # new tokens each; greedy, then sampled; greedy again on one slot
    class Recording(ServingEngine):
        """Keeps every sampled row's logits by (rid, output position)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits = {}

        def _sample(self, logits, reqs):
            rows = logits.float().cpu()
            for i, r in enumerate(reqs):
                if r is not None:
                    self.logits[(r.rid, len(r.out_tokens))] = rows[i]
            return super()._sample(logits, reqs)

    rng = np.random.RandomState(0)
    prompts = [rng.randint(0, V, n).tolist()
               for n in rng.randint(32, 129, size=8)]
    gen = 32

    def engine_run(tag, n_slots, sampling=None):
        eng = Recording(cfg, params, SchedulerConfig(
            n_slots=n_slots, max_len=128 + gen, prefill_chunk=16),
            device="cuda")
        for i, p in enumerate(prompts):
            eng.add_request(p, gen, sampling(i) if sampling else None)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_tok = sum(len(o.tokens) for o in outs)
        lat = latency_summary(outs)
        log(f"serve (c) {tag}: {len(outs)} requests on {n_slots} slots, "
            f"{n_tok} tokens in {wall:.3f}s ({n_tok / wall:.2f} tok/s), "
            f"{eng.n_steps} engine steps; TTFT p50 {lat['ttft_s']['p50']}s, "
            f"e2e p50 {lat['e2e_s']['p50']}s, ITL p50 "
            f"{lat['itl_s']['p50']}s")
        if len(outs) != len(prompts) or any(len(o.tokens) != gen
                                            for o in outs):
            raise AssertionError(f"serve (c) {tag}: requests unfinished")
        return outs, eng.logits

    greedy, rec4 = engine_run("greedy", 4)
    engine_run("temperature 0.8, top_k 40", 4,
               lambda i: SamplingParams(temperature=0.8, top_k=40, seed=i))
    alone, rec1 = engine_run("greedy, one slot", 1)
    # batched against alone: logits within the bound up to each request's
    # first differing token, and the tokens wherever the margin exceeds it
    scale = max(v.abs().max().item() for v in rec1.values())
    bound = 1e-4 * scale
    worst, ties = 0.0, 0
    for a, b in zip(greedy, alone):
        for pos in range(gen):
            la, lb = rec4[(a.rid, pos)], rec1[(b.rid, pos)]
            worst = max(worst, (la - lb).abs().max().item())
            if a.tokens[pos] != b.tokens[pos]:
                ties += check_tokens(f"serve (c) rid {a.rid} position {pos}",
                                     torch.tensor([a.tokens[pos]]),
                                     torch.tensor([b.tokens[pos]]),
                                     lb[None], bound)
                break
    log(f"serve (c) batched vs alone: greedy tokens "
        f"{'equal' if ties == 0 else f'{ties} near-ties'}; max |logit "
        f"batched - alone| = {worst} = {worst / scale} of max |logit| "
        f"{scale} (bar 1e-4)")
    if worst > bound:
        raise AssertionError("serve (c): batched and alone logits differ")
    del params

    # (d) the card (TF32 off) against the CPU: full width, depth of the
    # first period (6 Mamba2 blocks and the shared attention), L 512
    short = replace(cfg, block_pattern=cfg.block_pattern[:7], n_layers=6)
    smodel = get_model(short)
    p_cpu = smodel.init(3, short, device="cpu")
    p_card = T.tree_map(lambda t: t.cuda(), p_cpu)
    toks = torch.from_numpy(np.random.RandomState(2).randint(0, V, (1, 512)))
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smodel.forward(p_card, {"tokens": toks.cuda()}, short, True,
                          logits_slice="last")[0].float().cpu()
    t0 = time.perf_counter()
    cpu = smodel.forward(p_cpu, {"tokens": toks}, short, True,
                         logits_slice="last")[0].float()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    err = ((card - cpu).abs().max() / cpu.abs().max()).item()
    log(f"serve (d) card vs CPU (TF32 off for cudnn and matmul), depth 7 (6 "
        f"Mamba2 + shared attention), L 512: max |logit card - cpu| / max "
        f"|logit| = {err} (bar 1e-4; CPU "
        f"forward {time.perf_counter() - t0:.1f}s)")
    if not err <= 1e-4:
        raise AssertionError("serve (d): card and CPU disagree")
    return launches


# -- phases 10 and 11: the semi-async engine and the fleet ------------------
# phase 10's fleet: a quarter of the clients 4x slower, H_i in (4, 8), 5%
# of uploads lost, buffered-4 flushes
ASYNC_HETERO = dict(enabled=True, speed_dist="bimodal", straggler_frac=0.25,
                    straggler_slowdown=4.0, local_steps_choices=(4, 8),
                    drop_prob=0.05, seed=0)
ASYNC_FLUSHES = 12
# the example's wire: top-k 10% with EF up, the lossless delta downlink per
# client with resync_horizon 2; (b) the same uplink on the sparse wire
ASYNC_WIRES = {
    "a_topk_unicast": dict(compressor="topk", topk_frac=TOPK_FRAC,
                           downlink_compressor="delta",
                           downlink_unicast=True, resync_horizon=2),
    "b_sparse_unicast": dict(compressor="topk", topk_frac=TOPK_FRAC,
                             sparse_uplink=True, sparse_aggregate=True,
                             downlink_compressor="delta",
                             downlink_unicast=True, resync_horizon=2),
}
FLEET_REGIONS = 4
FLEET_PAGES = 8           # EF pages the paged store's budget holds


def dispatch_waves(engine):
    """The dispatch waves of an async run, read off its event log: each
    maximal run of dispatch events is one ``_dispatch`` call ->
    [(version, [clients])]."""
    waves, cur = [], None
    for kind, _, client, version in engine.event_log:
        if kind != "dispatch":
            cur = None
            continue
        if cur is None:
            cur = (version, [])
            waves.append(cur)
        cur[1].append(client)
    return waves


def expected_async_launches(engine, n_leaves, sparse):
    """The launches an async run makes, from its event log: each wave's
    clients train in one group per H_i (nesterov: two axpy sweeps a step;
    the dense top-k uplink one select sweep a group), each flush one
    aggregate and one server step."""
    groups = table_groups(n_leaves)
    want = {"fused_axpy": 0, "local_update": 0, "server_update": 0,
            "weighted_reduce": 0, "threshold_select": 0, "qsgd": 0,
            "sparse_reduce": 0, "kd_loss": 0, "kd_loss_bwd": 0,
            "flash_attention": 0, "ssd_scan": 0}
    n_groups = {}
    for _, clients in dispatch_waves(engine):
        for h in sorted({int(engine.system.local_steps[c]) for c in clients}):
            n_groups[h] = n_groups.get(h, 0) + 1
            want["fused_axpy"] += 2 * h * groups
            if not sparse:
                want["threshold_select"] += groups
    want["server_update"] = engine.version * groups
    if sparse:
        want["sparse_reduce"] = engine.version
    else:
        want["weighted_reduce"] = engine.version * groups
    return want, n_groups


def update_rel_err(torch, T, got, want, start):
    """|got - want| / |want - start| over whole trees (on the host)."""
    num = sum(((a.cpu().double() - b.cpu().double()) ** 2).sum()
              for a, b in zip(T.leaves(got), T.leaves(want)))
    den = sum(((b.cpu().double() - p.cpu().double()) ** 2).sum()
              for b, p in zip(T.leaves(want), T.leaves(start)))
    return (num / den).sqrt().item()


def async_phase(torch, data):
    """Phase 10: the semi-async engine at the main path's full width."""
    from repro_torch import async_straggler_example
    from repro_torch.configs.base import FedConfig, HeteroConfig
    from repro_torch.core import tree as T
    from repro_torch.federated.async_engine import AsyncFederatedSimulator
    from repro_torch.federated.simulator import FederatedSimulator, SimConfig
    from repro_torch.kernels import ops
    from repro_torch.models.vision import cnn_init
    x, y, xt, yt, parts = data
    params0 = cnn_init(17, width=32, image_size=32, device="cpu")
    n_leaves = len(T.leaves(params0))

    def engine(wire, hetero, buffer_k, rounds):
        return AsyncFederatedSimulator(
            FedConfig(eta=ETA, buffer_k=buffer_k, **wire),
            SimConfig(model="cnn", n_classes=10, rounds=rounds,
                      eval_every=rounds, cnn_width=32, seed=17),
            HeteroConfig(**hetero), x, y, xt, yt, parts,
            params=T.tree_map(lambda t: t.clone(), params0))

    for tag, wire in ASYNC_WIRES.items():
        sparse = bool(wire.get("sparse_uplink"))
        # run 1: the launches and the bytes, untimed
        e1 = engine(wire, ASYNC_HETERO, 4, ASYNC_FLUSHES)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        hist = e1.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = ops.launch_counts()
        want, n_groups = expected_async_launches(e1, n_leaves, sparse)
        kinds = [ev[0] for ev in e1.event_log]
        log(f"async {tag}: {ASYNC_FLUSHES} flushes in {run_s:.3f}s "
            f"(virtual time {e1.vtime}), {kinds.count('dispatch')} "
            f"dispatches in {sum(n_groups.values())} groups by H_i "
            f"{n_groups}, {kinds.count('arrive')} arrivals, "
            f"{kinds.count('drop')} drops; staleness "
            f"{e1.staleness_hist.to_dict()}; last {hist[-1]}")
        log(f"async {tag}: launches {counts}, expected {want}")
        if counts != want:
            raise AssertionError(f"async {tag}: kernel launches differ from "
                                 f"the count the event log predicts")
        if not (e1.staleness_hist.max >= 1 and math.isfinite(hist[-1]["loss"])
                and e1.version == ASYNC_FLUSHES):
            raise AssertionError(f"async {tag}: no stale delta, a "
                                 f"non-finite loss or a short run")
        tr = e1.transport
        up_want = kinds.count("arrive") * tr.uplink_wire_nbytes(e1.params)
        down_want = expected_downlink_bytes(e1.fed, tr, dispatch_waves(e1))
        log(f"async {tag}: uplink bytes {e1.uplink_bytes} (wire sizes give "
            f"{up_want}, raw {e1.uplink_bytes_raw}); downlink bytes "
            f"{e1.downlink_bytes} (the unicast ledger gives {down_want}, raw "
            f"{e1.downlink_bytes_raw}); catch-ups {e1.refs.catchups}, "
            f"resyncs {e1.refs.resyncs}")
        if (e1.uplink_bytes, e1.downlink_bytes) != (up_want, down_want):
            raise AssertionError(f"async {tag}: measured bytes differ from "
                                 f"the wire sizes")
        # run 2 from the same seeds, each flush and dispatch group timed
        # (synchronised), the sixth flush profiled
        e2 = engine(wire, ASYNC_HETERO, 4, ASYNC_FLUSHES)
        flush_ms, group_ms, prof = [], {}, {}
        flush, client_half = e2._flush, e2._client_half

        def timed_flush(buffer):
            if len(flush_ms) == 5 and not prof:
                out = []
                prof["wall"], prof["rows"], prof["busy"] = profiled(
                    torch, lambda: out.append(flush(buffer)))
                return out[0]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = flush(buffer)
            torch.cuda.synchronize()
            flush_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def timed_group(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = client_half(*args)
            torch.cuda.synchronize()
            group_ms.setdefault(args[2].shape[1], []).append(
                (time.perf_counter() - t0) * 1e3)
            return out
        e2._flush, e2._client_half = timed_flush, timed_group
        e2.run()
        same = (list(e2.event_log) == list(e1.event_log)
                and e2.staleness_hist.to_dict()
                == e1.staleness_hist.to_dict())
        log(f"async {tag}: second run from the same seeds: event log and "
            f"staleness histogram identical: {same}")
        if not same:
            raise AssertionError(f"async {tag}: the event log is not "
                                 f"deterministic")
        med = sorted(flush_ms)[len(flush_ms) // 2]
        log(f"async {tag}: ms per flush (synchronised) {flush_ms}, median "
            f"{med:.3f}; ms per dispatch group by H_i "
            f"{ {h: [round(v, 3) for v in ms] for h, ms in group_ms.items()} }")
        idle_share(f"async {tag} flush profile", "flush", prof["wall"],
                   prof["rows"], prof["busy"], med, 8)

    # (c) heterogeneity off, buffer_k = 0: two flushes against two sync
    # rounds from the same parameters and picks, cuDNN deterministic
    cudnn_det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    e = engine({}, {}, 0, 2)
    e.run()
    s = FederatedSimulator(FedConfig(eta=ETA),
                           SimConfig(model="cnn", n_classes=10, cnn_width=32,
                                     seed=17),
                           x, y, xt, yt, parts,
                           params=T.tree_map(lambda t: t.clone(), params0))
    for _ in range(2):
        s.run_round(*s.next_round_inputs())
    torch.backends.cudnn.deterministic = cudnn_det
    err = update_rel_err(torch, T, e.params, s.params, params0)
    biggest = max((a - b).abs().max().item()
                  for a, b in zip(T.leaves(e.params), T.leaves(s.params)))
    log(f"async (c) hetero off, buffer_k 0: 2 flushes against 2 sync "
        f"rounds: |dθ async - dθ sync| / |dθ sync| = {err} (bar 1e-4), "
        f"largest |θ async - θ sync| = {biggest}, staleness "
        f"{e.staleness_hist.to_dict()}")
    if not (err <= 1e-4 and e.staleness_hist.max == 0):
        raise AssertionError("async (c): the engine departs from the sync "
                             "simulator with heterogeneity off")

    # (d) the port's async straggler example
    t0 = time.perf_counter()
    engines = async_straggler_example.run(device="cuda")
    semi = engines["semi"].history[-1]
    log(f"async (d) example: {time.perf_counter() - t0:.1f}s; sync "
        f"{engines['sync'].history[-1]}, semi {semi}")
    if not (math.isfinite(semi["loss"]) and 0.0 <= semi["acc"] <= 1.0):
        raise AssertionError("async (d): the example's result is bad")


def fleet_phase(torch, data):
    """Phase 11: the fleet substrate at the main path's full width."""
    import tempfile
    import zlib

    from repro_torch.checkpointing.checkpoint import (restore_checkpoint,
                                                      save_checkpoint,
                                                      storage_view)
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import tree as T
    from repro_torch.federated.fleet import (FleetScheduler,
                                             PagedClientStore, page_nbytes)
    from repro_torch.federated.fleet.paged_store import COMPRESS_LEVEL
    from repro_torch.federated.protocol import RoundProtocol
    from repro_torch.federated.simulator import FederatedSimulator, SimConfig
    from repro_torch.federated.store import ClientStore
    from repro_torch.kernels import ops
    from repro_torch.telemetry import Counters
    x, y, xt, yt, parts = data

    def same_bits(a, b):
        return all(u.dtype == v.dtype and u.shape == v.shape
                   and storage_view(u).tobytes() == storage_view(v).tobytes()
                   for u, v in zip(T.leaves(a), T.leaves(b)))

    # (a) one round's stacked deltas through protocol.aggregate
    sim = FederatedSimulator(
        FedConfig(eta=ETA), SimConfig(model="cnn", n_classes=10,
                                      cnn_width=32, seed=19),
        x, y, xt, yt, parts)
    picks, xb, yb = sim.next_round_inputs()
    counts = torch.as_tensor(sim.counts[picks], dtype=torch.float32,
                             device="cuda")
    params_w, ctx, _ = sim.protocol.client_ctx(sim.server_state, sim.params)
    dense = sim._client_half(params_w, ctx, xb, yb, counts, None,
                             sim.protocol.store.gather("ef", picks), None)[0]
    sparse_fed = FedConfig(eta=ETA, **WIRES["b_topk_sparse"])
    wire, _ = RoundProtocol(sparse_fed).uplink_encode(
        dense, T.zeros_like(dense))
    weights = torch.ones(K, device="cuda")
    n_leaves = len(T.leaves(sim.params))
    for kind, deltas, base in (("dense", dense, {}),
                               ("sparse", wire, WIRES["b_topk_sparse"])):
        out, ms, launched = {}, {}, {}
        for regions in (0, 1, FLEET_REGIONS):
            proto = RoundProtocol(FedConfig(eta=ETA, fleet_regions=regions,
                                            **base))

            def agg(proto=proto):
                return proto.aggregate(deltas, weights, like=sim.params)
            ops.reset_launch_counts()
            out[regions] = agg()
            torch.cuda.synchronize()
            launched[regions] = {n: c for n, c in ops.launch_counts().items()
                                 if c}
            ms[regions] = cuda_ms(torch, agg)
        flat, r1, r4 = out[0], out[1], out[FLEET_REGIONS]
        bitwise = same_bits(flat, r1)
        rel = max(((a - b).abs().max() / b.abs().max()).item()
                  for a, b in zip(T.leaves(r4), T.leaves(flat)))
        groups = table_groups(n_leaves)
        want = ({"weighted_reduce": (FLEET_REGIONS + 1) * groups}
                if kind == "dense" else
                {"sparse_reduce": FLEET_REGIONS, "weighted_reduce": groups})
        log(f"fleet (a) {kind}: R=1 bit for bit flat: {bitwise}; R="
            f"{FLEET_REGIONS} max |hier - flat| / max |flat| over leaves "
            f"{rel} (bar 1e-5); launches {launched}; ms flat {ms[0]}, R=1 "
            f"{ms[1]}, R={FLEET_REGIONS} {ms[FLEET_REGIONS]}")
        if not (bitwise and rel <= 1e-5
                and launched[FLEET_REGIONS] == want):
            raise AssertionError(f"fleet (a) {kind}: the hierarchical "
                                 f"aggregate departs from flat or launches "
                                 f"other than {want}")
    del dense, wire

    # (b) four sync rounds with a FleetScheduler and a paged EF store that
    # holds FLEET_PAGES pages, every scatter mirrored into a plain store
    fed = FedConfig(eta=ETA, fleet_regions=FLEET_REGIONS,
                    **WIRES["a_topk_dense"])
    ef_page = page_nbytes(T.zeros_like(sim.params))
    store = PagedClientStore(budget_bytes=FLEET_PAGES * ef_page,
                             counters=Counters())
    s = FederatedSimulator(
        fed, SimConfig(model="cnn", n_classes=10, cnn_width=32, seed=19),
        x, y, xt, yt, parts, store=store,
        scheduler=FleetScheduler(fed, seed=19))
    plain = ClientStore()
    plain.register("ef", s._ef_init)
    scatter, encode, decode = store.scatter, store._encode, store._decode
    spill_ms, fault_ms = [], []

    def tee(name, picks, stacked):
        plain.scatter(name, picks, stacked)
        scatter(name, picks, stacked)

    def timed_encode(key, page):
        t0 = time.perf_counter()
        out = encode(key, page)
        spill_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def timed_decode(name, blob):
        t0 = time.perf_counter()
        out = decode(name, blob)
        torch.cuda.synchronize()
        fault_ms.append((time.perf_counter() - t0) * 1e3)
        return out
    store.scatter, store._encode, store._decode = (tee, timed_encode,
                                                   timed_decode)
    round_s, cohorts = [], []
    for _ in range(4):
        inputs = s.next_round_inputs()
        cohorts.append(inputs[0].tolist())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = s.run_round(*inputs)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        if not torch.isfinite(loss):
            raise AssertionError(f"fleet (b): non-finite loss {loss}")
    in_rounds = (store.counters.get("store.spills"),
                 store.counters.get("store.loads"))
    everyone = list(range(s.n_clients))
    same = all(same_bits(T.tree_map(lambda t: t[0], store.gather("ef", [c])),
                         T.tree_map(lambda t: t[0], plain.gather("ef", [c])))
               for c in everyone)
    spills, faults = (store.counters.get("store.spills"),
                      store.counters.get("store.loads"))
    log(f"fleet (b): R={FLEET_REGIONS} cohorts {cohorts}; round seconds "
        f"{round_s}; EF page {ef_page} bytes, budget {store.budget_bytes} "
        f"({FLEET_PAGES} pages), peak resident {store.peak_resident_bytes}; "
        f"spills/faults in the rounds {in_rounds}, after gathering all "
        f"{len(everyone)} clients back {(spills, faults)}; every page bit "
        f"for bit the plain store's: {same}")
    # one EF page's spill split into its two parts
    page = T.zeros_like(sim.params)
    for t in T.leaves(page):
        t.normal_()
    t0 = time.perf_counter()
    bits = [storage_view(t).tobytes() for t in T.leaves(page)]
    d2h_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    packed = [zlib.compress(b, COMPRESS_LEVEL) for b in bits]
    zlib_ms = (time.perf_counter() - t0) * 1e3
    log(f"fleet (b): ms per spill (D2H + zlib) {[round(v, 3) for v in spill_ms]}"
        f"; ms per fault (zlib + H2D) {[round(v, 3) for v in fault_ms]}; one "
        f"N(0, 1) page's spill: D2H and bit view {d2h_ms:.3f} ms, zlib level "
        f"{COMPRESS_LEVEL} {zlib_ms:.3f} ms, {sum(map(len, bits))} -> "
        f"{sum(map(len, packed))} bytes")
    if not (same and store.peak_resident_bytes <= store.budget_bytes
            and spills > 0 and faults > 0):
        raise AssertionError("fleet (b): the paged store breaks its budget, "
                             "never spills or faults, or loses a page")

    # (c) checkpoints of the CNN's parameters and FedADC's fp32 momentum,
    # with bf16 and fp8 copies; and paged pages in those dtypes
    tree = {"params": s.params, "momentum": s.server_state["m"],
            "bf16": T.cast(s.params, torch.bfloat16),
            "e4m3": T.cast(s.params, torch.float8_e4m3fn),
            "e5m2": T.cast(s.params, torch.float8_e5m2)}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as d:
        t0 = time.perf_counter()
        save_checkpoint(d, 4, tree)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_checkpoint(d, 4, tree)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    ok = {k: same_bits(back[k], tree[k]) for k in tree}
    log(f"fleet (c) checkpoint: {sum(t.numel() * t.element_size() for t in T.leaves(tree))} "
        f"bytes saved in {save_s:.3f}s, restored to the card in "
        f"{restore_s:.3f}s; bit for bit by part: {ok}")
    pages = {}
    for dt in (torch.float32, torch.bfloat16, torch.float8_e4m3fn,
               torch.float8_e5m2):
        one = T.cast(s.params, dt)
        ps = PagedClientStore(budget_bytes=page_nbytes(one))
        ps.register("p", lambda one=one: T.zeros_like(one))
        # three pages (θ, -θ, 2θ), negated and doubled before the cast
        stacked = T.tree_map(lambda t, dt=dt: torch.stack([t, -t, 2 * t])
                             .to(dt), s.params)
        ps.scatter("p", [0, 1, 2], stacked)
        pages[str(dt)] = (ps.spilled_pages == 2
                          and same_bits(ps.gather("p", [0, 1, 2]), stacked))
    log(f"fleet (c) paged store, three pages through a one-page budget: "
        f"bit for bit by dtype {pages}")
    if not (all(ok.values()) and all(pages.values())):
        raise AssertionError("fleet (c): a checkpoint or a page did not "
                             "round-trip bit for bit")


# -- phase 12: the paper's benchmark drivers ----------------------------------
# each driver's rows, by name, in the order the reference's driver emits them
# (tests/test_torch_benchmarks.py holds this literal to the reference's)
# the harness's modules that other phases run (phase 12 runs the rest)
OTHER_PHASE_BENCHES = {"lm_round": 15, "roofline_report": 16,
                       "kernels_bench": 16}
BENCH_ROWS = {
    "fig1_acceleration": [
        "fig1.s2.fedavg", "fig1.s2.slowmo", "fig1.s2.fedadc",
        "fig1.s2.fedadc_minus_fedavg", "fig1.s3.fedavg", "fig1.s3.slowmo",
        "fig1.s3.fedadc", "fig1.s3.fedadc_minus_fedavg", "fig1.s4.fedavg",
        "fig1.s4.slowmo", "fig1.s4.fedadc", "fig1.s4.fedadc_minus_fedavg",
    ],
    "fig2_robustness": [
        "fig2.s2.final", "fig2.s2.early", "fig2.s3.final", "fig2.s3.early",
        "fig2.s4.final", "fig2.s4.early", "fig2.final_acc_spread",
        "fig2.s2.nesterov", "fig2.s2.heavyball",
    ],
    "ablation_beta": [
        "ablation.beta0.6", "ablation.beta0.7", "ablation.beta0.8",
        "ablation.beta0.9", "ablation.beta_local_0",
        "ablation.beta_local_half", "ablation.beta_local_full",
        "ablation.drift_control_gain",
    ],
    "clustering": [
        "clustering.random", "clustering.class_coverage",
        "clustering.coverage_minus_random",
    ],
    "table1_sota": [
        "table1.s2.fedavg", "table1.s2.moon", "table1.s2.fedgkd",
        "table1.s2.fedntd", "table1.s2.feddyn", "table1.s2.fedprox",
        "table1.s2.scaffold", "table1.s2.fedadc", "table1.s2.fedadc+",
        "table1.s2.fedrs", "table1.s2.ours_minus_best_baseline",
        "table1.dir0.3.fedavg", "table1.dir0.3.moon", "table1.dir0.3.fedgkd",
        "table1.dir0.3.fedntd", "table1.dir0.3.feddyn",
        "table1.dir0.3.fedprox", "table1.dir0.3.scaffold",
        "table1.dir0.3.fedadc", "table1.dir0.3.fedadc+",
        "table1.dir0.3.ours_minus_best_baseline",
    ],
    "fig5_scale": [
        "fig5.C0.06.fedadc+", "fig5.C0.06.feddyn", "fig5.C0.06.fedavg",
    ],
    "fig7_personalization": [
        "fig7.global_model_local_acc", "fig7.personalized.none",
        "fig7.gain.none", "fig7.personalized.prox", "fig7.gain.prox",
        "fig7.personalized.kd", "fig7.gain.kd",
    ],
    "straggler_bench": [
        "straggler.sync.t_to_target", "straggler.semi.t_to_target",
        "straggler.semi_vs_sync_speedup", "straggler.semi.max_staleness",
    ],
    "fleet_bench": [
        "fleet.K1000.flat", "fleet.K1000.hier", "fleet.K10000.flat",
        "fleet.K10000.hier", "fleet.K100000.flat", "fleet.K100000.hier",
    ],
    "comm_load": [
        "comm.qwen3-4b.fedavg", "comm.qwen3-4b.slowmo",
        "comm.qwen3-4b.fedadc_naive", "comm.qwen3-4b.fedadc_overlap",
        "comm.qwen3-4b.measured.up.raw", "comm.qwen3-4b.measured.up.topk10",
        "comm.qwen3-4b.measured.up.qsgd4", "comm.qwen3-4b.measured.up.qsgd8",
        "comm.qwen3-4b.measured.down.fedavg.raw",
        "comm.qwen3-4b.measured.down.fedavg.topk10",
        "comm.qwen3-4b.measured.down.fedavg.qsgd8",
        "comm.qwen3-4b.measured.down.fedavg.delta",
        "comm.qwen3-4b.measured.down.fedavg.delta_topk10",
        "comm.qwen3-4b.measured.down.fedavg.delta_qsgd8",
        "comm.qwen3-4b.measured.down.slowmo.raw",
        "comm.qwen3-4b.measured.down.slowmo.topk10",
        "comm.qwen3-4b.measured.down.slowmo.qsgd8",
        "comm.qwen3-4b.measured.down.slowmo.delta",
        "comm.qwen3-4b.measured.down.slowmo.delta_topk10",
        "comm.qwen3-4b.measured.down.slowmo.delta_qsgd8",
        "comm.qwen3-4b.measured.down.fedadc.raw",
        "comm.qwen3-4b.measured.down.fedadc.topk10",
        "comm.qwen3-4b.measured.down.fedadc.qsgd8",
        "comm.qwen3-4b.measured.down.fedadc.delta",
        "comm.qwen3-4b.measured.down.fedadc.delta_topk10",
        "comm.qwen3-4b.measured.down.fedadc.delta_qsgd8",
        "comm.qwen3-4b.fedadc_delta_downlink",
        "comm.qwen3-4b.unicast.delta.h4", "comm.qwen3-4b.unicast.delta.h0",
        "comm.qwen3-4b.unicast.delta_identity.h4",
        "comm.qwen3-4b.unicast.delta_identity.h0", "comm.qwen3-14b.fedavg",
        "comm.qwen3-14b.slowmo", "comm.qwen3-14b.fedadc_naive",
        "comm.qwen3-14b.fedadc_overlap", "comm.qwen3-14b.measured.up.raw",
        "comm.qwen3-14b.measured.up.topk10",
        "comm.qwen3-14b.measured.up.qsgd4", "comm.qwen3-14b.measured.up.qsgd8",
        "comm.qwen3-14b.measured.down.fedavg.raw",
        "comm.qwen3-14b.measured.down.fedavg.topk10",
        "comm.qwen3-14b.measured.down.fedavg.qsgd8",
        "comm.qwen3-14b.measured.down.fedavg.delta",
        "comm.qwen3-14b.measured.down.fedavg.delta_topk10",
        "comm.qwen3-14b.measured.down.fedavg.delta_qsgd8",
        "comm.qwen3-14b.measured.down.slowmo.raw",
        "comm.qwen3-14b.measured.down.slowmo.topk10",
        "comm.qwen3-14b.measured.down.slowmo.qsgd8",
        "comm.qwen3-14b.measured.down.slowmo.delta",
        "comm.qwen3-14b.measured.down.slowmo.delta_topk10",
        "comm.qwen3-14b.measured.down.slowmo.delta_qsgd8",
        "comm.qwen3-14b.measured.down.fedadc.raw",
        "comm.qwen3-14b.measured.down.fedadc.topk10",
        "comm.qwen3-14b.measured.down.fedadc.qsgd8",
        "comm.qwen3-14b.measured.down.fedadc.delta",
        "comm.qwen3-14b.measured.down.fedadc.delta_topk10",
        "comm.qwen3-14b.measured.down.fedadc.delta_qsgd8",
        "comm.qwen3-14b.fedadc_delta_downlink",
        "comm.qwen3-14b.unicast.delta.h4", "comm.qwen3-14b.unicast.delta.h0",
        "comm.qwen3-14b.unicast.delta_identity.h4",
        "comm.qwen3-14b.unicast.delta_identity.h0",
    ],
    "serving_bench": [
        "serving.slots1.tokens_per_s", "serving.slots1.p50_p95_s",
        "serving.slots1.ttft_itl_p50_s", "serving.slots2.tokens_per_s",
        "serving.slots2.p50_p95_s", "serving.slots2.ttft_itl_p50_s",
        "serving.slots4.tokens_per_s", "serving.slots4.p50_p95_s",
        "serving.slots4.ttft_itl_p50_s", "serving.slots8.tokens_per_s",
        "serving.slots8.p50_p95_s", "serving.slots8.ttft_itl_p50_s",
        "serving.batch_vs_serial_speedup",
    ],
    "comm_sweep": [
        "comm_sweep.fedavg.none", "comm_sweep.fedavg.topk10_ef",
        "comm_sweep.fedavg.qsgd4_ef", "comm_sweep.slowmo.none",
        "comm_sweep.slowmo.topk10_ef", "comm_sweep.slowmo.qsgd4_ef",
        "comm_sweep.fedadc.none", "comm_sweep.fedadc.topk10_ef",
        "comm_sweep.fedadc.qsgd4_ef",
        "comm_sweep.async.fedadc.topk5_ef.stale_none",
        "comm_sweep.async.fedadc.topk5_ef.stale_poly",
        "comm_sweep.async.fedadc.topk20_ef.stale_none",
        "comm_sweep.async.fedadc.topk20_ef.stale_poly",
        "comm_sweep.async.fedadc.qsgd2_ef.stale_none",
        "comm_sweep.async.fedadc.qsgd2_ef.stale_poly",
        "comm_sweep.async.fedadc.qsgd8_ef.stale_none",
        "comm_sweep.async.fedadc.qsgd8_ef.stale_poly",
        "comm_sweep.intermittent.av1.0.h0", "comm_sweep.intermittent.av1.0.h4",
        "comm_sweep.intermittent.av0.5.h0", "comm_sweep.intermittent.av0.5.h4",
        "comm_sweep.downlink.fedadc.down_none",
        "comm_sweep.downlink.fedadc.down_delta",
        "comm_sweep.downlink.fedadc.down_delta_topk10",
        "comm_sweep.downlink.fedadc.down_delta_qsgd8",
        "comm_sweep.drift.fedadc_none",
        "comm_sweep.fedadc_topk10_vs_uncompressed",
        "comm_sweep.fedadc_delta_downlink_vs_naive",
        "comm_sweep.unicast_catchup_vs_resync",
    ],
    "telemetry_bench": [
        "telemetry.sync_round_overhead", "telemetry.enabled_acc_identical",
    ],
}
# ROUNDS a figure driver runs at inside phase 12, where the phase cuts it
# (module -> rounds); a driver not named here runs at its own ROUNDS.  At
# their own ROUNDS the drivers took 301.7 s on one H100 (700 W), so it keeps
# fig1 and clustering whole and halves the rest (fig2 needs a multiple of
# 3: it evaluates every ROUNDS // 3); `python -m repro_torch.benchmarks.run`
# runs them all at their own ROUNDS.  fig7 trains its fixed 20 rounds.
BENCH_CUTS = {"fig2_robustness": 30, "ablation_beta": 25, "table1_sota": 25,
              "fig5_scale": 25}
# the fleet bench's fields that depend only on the seed and the sizes: they
# must equal the committed BENCH_fleet.json's (its rounds_per_s may differ)
FLEET_FIELDS = ("peak_staging_bytes", "peak_store_bytes", "peak_host_bytes",
                "budget_ok", "spills_per_round", "loads_per_round")
FLEET_HEADLINE = ("hier_le_flat_peak_at_1e5", "budget_ok_at_1e5",
                  "peak_host_hier_over_flat_at_1e5")
# the kernels the drivers run; the wire and LM kernels they never reach
BENCH_KERNELS = ("fused_axpy", "local_update", "server_update",
                 "weighted_reduce", "kd_loss", "kd_loss_bwd")


def expected_fl_launches(runs, n_leaves):
    """The launches of nesterov runs ``(strategy, rounds, H, distill)``:
    per round and 64 leaves, FedAvg's H SGD sweeps (fused_axpy) and one
    aggregate, SlowMo's the same and one server step, FedADC's 2H axpy
    sweeps (the half step and the step), one aggregate and one server
    step; FedADC+ adds H kd_loss and H kd_loss_bwd launches a round (one
    per step for all the round's clients)."""
    groups = table_groups(n_leaves)
    want = {name: 0 for name in ("fused_axpy", "local_update",
                                 "server_update", "weighted_reduce",
                                 "threshold_select", "qsgd", "sparse_reduce",
                                 "kd_loss", "kd_loss_bwd", "flash_attention",
                                 "ssd_scan")}
    for strategy, rounds, h, distill in runs:
        sweeps = 2 * h if strategy == "fedadc" else h
        want["fused_axpy"] += rounds * sweeps * groups
        want["weighted_reduce"] += rounds * groups
        want["server_update"] += rounds * groups * (strategy != "fedavg")
        if distill:
            want["kd_loss"] += rounds * h
            want["kd_loss_bwd"] += rounds * h
    return want


def derived(rows, name):
    return next(r.split(",", 2)[2] for r in rows if r.split(",")[0] == name)


def launch_diff(ops, before):
    return {n: c - before[n] for n, c in ops.launch_counts().items()}


def bench_phase(torch):
    """Phase 12: every ported driver's ``main(rows)`` on the card, in the
    order of ``BENCH_ROWS`` (the fleet bench with ``smoke=True``, then the
    serving smoke), nothing caught.  Checks the row names, fig1's
    FedADC-minus-FedAvg at s=2, the launches of fig1 and of Table I's
    first FedADC+ run, the fleet and serving smokes against the committed
    JSONs, comm_load's unicast and delta-downlink claims, and that the
    drivers launch their six kernels and no other; logs each
    driver's us column, its seconds, and the idle share of one profiled
    fig1 round."""
    import importlib
    from repro_torch.benchmarks import common
    from repro_torch.benchmarks.fleet_bench import FLEETS, REGIONS
    from repro_torch.kernels import ops
    from repro_torch.models.vision import cnn_init
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    n_leaves = len(leaf_shapes(cnn_init(0, width=8, image_size=16,
                                        device="cpu")))
    mods = {name: importlib.import_module(f"repro_torch.benchmarks.{name}")
            for name in BENCH_ROWS}
    for name, rounds in BENCH_CUTS.items():
        log(f"bench: {name} cut to ROUNDS {rounds} in this phase (its own: "
            f"{mods[name].ROUNDS})")
        mods[name].ROUNDS = rounds
    totals = {n: 0 for n in ops.KERNELS}
    seconds = {}

    def drive(name, **kw):
        """One driver's main on the card -> (its rows, its launches)."""
        rows, before = [], ops.launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mods[name].main(rows, device="cuda", **kw)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        counts = launch_diff(ops, before)
        for n, c in counts.items():
            totals[n] += c
        us = {r.split(",")[0]: float(r.split(",")[1]) for r in rows
              if float(r.split(",")[1]) != 0}
        log(f"bench {name}: {seconds[name]:.1f} s, {len(rows)} rows, "
            f"us column {json.dumps(us)}")
        if [r.split(",")[0] for r in rows] != BENCH_ROWS[name]:
            raise AssertionError(f"bench {name}: row names differ from the "
                                 f"reference's")
        return rows, counts

    # fig1: launches for its nine runs, the paper's claim at s=2
    rows, counts = drive("fig1_acceleration")
    r1 = mods["fig1_acceleration"].ROUNDS
    want = expected_fl_launches(
        [(s, r1, 8, False) for s in ("fedavg", "slowmo", "fedadc")] * 3,
        n_leaves)
    log(f"bench fig1: launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("bench fig1: kernel launches differ from the "
                             "count the rounds should make")
    gap = float(derived(rows, "fig1.s2.fedadc_minus_fedavg"))
    log(f"bench fig1: FedADC - FedAvg at s=2: {gap:+.3f}")
    if not gap > 0:
        raise AssertionError("bench fig1: FedADC does not beat FedAvg at s=2")
    # one more fig1 FedADC run at s=2: five timed rounds, then a profiled one
    data = common.dataset()
    sim = common.run_fl("fedadc", common.partitions(data[1], 20, "sort", 2),
                        data, rounds=1, eta=0.01, device="cuda")["sim"]
    round_s = []
    for _ in range(5):
        inputs = sim.next_round_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.run_round(*inputs)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
    log(f"bench fig1: fedadc s=2 round seconds {round_s}")
    profile_round(torch, sim, round_s, "bench fig1 profile", top=8)
    del sim

    drive("fig2_robustness")
    drive("ablation_beta")
    drive("clustering")
    # Table I: the launches of its first FedADC+ run (s2) on their own
    table1, table_counts = mods["table1_sota"], {}
    run_fl = table1.run_fl

    def counted(strategy, *a, distill=False, **k):
        first = distill and not table_counts
        before = ops.launch_counts()
        r = run_fl(strategy, *a, distill=distill, **k)
        if first:
            table_counts.update(launch_diff(ops, before))
        return r
    table1.run_fl = counted
    try:
        drive("table1_sota")
    finally:
        table1.run_fl = run_fl
    want = expected_fl_launches([("fedadc", table1.ROUNDS, 8, True)],
                                n_leaves)
    log(f"bench table1: the s2 FedADC+ run's launches {table_counts}, "
        f"expected {want}")
    if table_counts != want:
        raise AssertionError("bench table1: FedADC+ launches differ from the "
                             "count the rounds should make")
    drive("fig5_scale")
    drive("fig7_personalization")
    drive("straggler_bench")
    # the fleet bench's smoke: its byte fields against the committed JSON;
    # one weighted reduce a flat round, REGIONS + 1 a hierarchical one
    fleet_json = out_dir / "BENCH_fleet_torch.json"
    _, counts = drive("fleet_bench", out_json=str(fleet_json), smoke=True)
    mine = json.loads(fleet_json.read_text())
    ref_fleet = json.loads((ROOT / "BENCH_fleet.json").read_text())
    want_wr = len(FLEETS) * mine["rounds_per_cell"] * (1 + REGIONS + 1)
    mismatch = [
        (c["fleet"], c["mode"], k, c[k], r[k])
        for c, r in zip(mine["cells"], ref_fleet["cells"])
        for k in FLEET_FIELDS + ("fleet", "mode") if c[k] != r[k]]
    mismatch += [(k, mine["headline"][k], ref_fleet["headline"][k])
                 for k in FLEET_HEADLINE
                 if mine["headline"][k] != ref_fleet["headline"][k]]
    log(f"bench fleet: rounds_per_s "
        f"{[(c['fleet'], c['mode'], c['rounds_per_s']) for c in mine['cells']]}"
        f"; weighted_reduce launches {counts['weighted_reduce']} (expected "
        f"{want_wr}); fields differing from BENCH_fleet.json: {mismatch}")
    if mismatch or len(mine["cells"]) != len(ref_fleet["cells"]) \
            or counts["weighted_reduce"] != want_wr:
        raise AssertionError("bench fleet: the smoke differs from the "
                             "committed BENCH_fleet.json")
    # comm_load: under full participation a unicast delta within its resync
    # horizon (h4) costs what multicast does; at horizon 0 every returning
    # client resyncs (the reference's rows say False there too)
    rows, _ = drive("comm_load")
    chained = [r for r in rows if ".unicast." in r.split(",")[0]
               and r.split(",")[0].endswith(".h4")]
    resync = [r for r in rows if ".unicast." in r.split(",")[0]
              and r.split(",")[0].endswith(".h0")]
    delta = [r for r in rows if r.split(",")[0].endswith(
        ".fedadc_delta_downlink")]
    if not (len(chained) == len(resync) == 4 and len(delta) == 2
            and all("full_eq_multicast=True" in r for r in chained)
            and all(";catchups=0;" in r for r in resync)
            and all(r.endswith("le_1p1=True") for r in delta)):
        raise AssertionError("bench comm_load: full participation unicast "
                             "!= multicast within the horizon, or the delta "
                             "downlink > 1.1x")
    log("bench comm_load: full_eq_multicast=True on the 4 h4 unicast rows "
        "(h0: resyncs only), le_1p1=True for both archs")
    drive("serving_bench", out_json=str(out_dir / "BENCH_serving_torch.json"))
    # the serving smoke: no stop rule but max_new_tokens ends a request, so
    # its counters depend only on the lengths and the scheduler
    t0 = time.perf_counter()
    report = mods["serving_bench"].smoke(
        out_json=str(out_dir / "BENCH_serving_smoke_torch.json"),
        device="cuda")
    want = json.loads((ROOT / "BENCH_serving_smoke.json").read_text())
    log(f"bench serving smoke: {time.perf_counter() - t0:.1f} s, {report} "
        f"(committed: {want})")
    if report != want:
        raise AssertionError("bench serving smoke: counters differ from the "
                             "committed BENCH_serving_smoke.json")
    log(f"bench: launches over the phase {totals}")
    if min(totals[n] for n in BENCH_KERNELS) == 0 or any(
            c for n, c in totals.items() if n not in BENCH_KERNELS):
        raise AssertionError("bench: a driver kernel never launched, or a "
                             "kernel off the drivers' path did")
    log(f"bench: driver seconds {json.dumps(seconds)}; phase "
        f"{time.perf_counter() - t_phase:.1f} s")


# -- phase 13: telemetry ------------------------------------------------------
# the drift keys of a FedADC round without EF: the reference's
# round_metrics and the loss (EF adds ef_residual_norm)
DRIFT_KEYS = {"delta_dispersion", "update_norm", "momentum_alignment", "loss"}
TELEMETRY_ROUNDS = 4
# the rounds telemetry_bench and comm_sweep run at inside phase 13 (their
# own: 40 with a warm-up of 4; 90 sync, 80 async, 40 intermittent)
TELEMETRY_CUTS = {"rounds": 10, "warmup": 2}
COMM_CUTS = {"rounds": 10, "async_rounds": 10, "intermittent_rounds": 8}


def unicast_classes(horizon, waves):
    """(fresh, catch-ups, resyncs) of unicast dispatch waves
    ``(version, picks)``: a client never seen, or more than ``horizon``
    versions behind, resyncs; one at the wave's version is fresh; the rest
    catch up."""
    fresh = catchups = resyncs = 0
    last_seen = {}
    for version, picks in waves:
        for c in map(int, picks):
            last = last_seen.get(c)
            if last is None or version - last > horizon:
                resyncs += 1
            elif version == last:
                fresh += 1
            else:
                catchups += 1
            last_seen[c] = version
    return fresh, catchups, resyncs


def predicted_bytes(sim):
    """The four byte counters of a finished ``run_fl`` / ``run_fl_async``
    engine, from its uploads and dispatch waves and the transport's
    per-client sizes: a sync round uploads and dispatches |S| clients; an
    async run uploads its arrivals and dispatches its waves (event log)."""
    tr, fed = sim.transport, sim.fed
    if hasattr(sim, "event_log"):
        n_up = sum(ev[0] == "arrive" for ev in sim.event_log)
        waves = dispatch_waves(sim)
    else:
        n_up = sim._rounds_done * fed.clients_per_round
        waves = [(r, range(fed.clients_per_round))
                 for r in range(sim._rounds_done)]
    n_down = sum(len(p) for _, p in waves)
    return {"uplink_bytes": n_up * tr._up_nbytes,
            "uplink_bytes_raw": n_up * tr._up_raw,
            "downlink_bytes": expected_downlink_bytes(fed, tr, waves),
            "downlink_bytes_raw": n_down * tr._down_raw}, waves


def drift_rel_err(a, b):
    """The largest |a_k − b_k| / |b_k| over two drift dicts' keys (absolute
    where b_k is 0)."""
    if set(a) != set(b):
        return math.inf
    return max(abs(a[k] - b[k]) / (abs(b[k]) or 1.0) for k in b)


def telemetry_phase(torch, data):
    """Phase 13: telemetry on the three engines and its two drivers; its
    JSONL and JSON files live in a temporary directory."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="telemetry_phase_") as d:
        _telemetry_phase(torch, data, Path(d))


def _telemetry_phase(torch, data, tmp):
    import importlib
    from repro_torch.benchmarks import serving_bench
    from repro_torch.configs.base import FedConfig, HeteroConfig
    from repro_torch.core import tree as T
    from repro_torch.federated.async_engine import AsyncFederatedSimulator
    from repro_torch.federated.simulator import FederatedSimulator, SimConfig
    from repro_torch.kernels import ops
    from repro_torch.models.vision import cnn_init
    from repro_torch.serving import SchedulerConfig, ServingEngine
    from repro_torch.telemetry import Telemetry, validate_jsonl
    x, y, xt, yt, parts = data
    params0 = cnn_init(19, width=32, image_size=32, device="cpu")
    n_leaves = len(T.leaves(params0))
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)

    def sim(fed_kw, telemetry=None, device=None, rounds=TELEMETRY_ROUNDS):
        return FederatedSimulator(
            FedConfig(eta=ETA, **fed_kw),
            SimConfig(model="cnn", n_classes=10, rounds=rounds,
                      eval_every=rounds, cnn_width=32, seed=19),
            x, y, xt, yt, parts,
            params=T.tree_map(lambda t: t.clone(), params0),
            telemetry=telemetry, device=device)

    # (a) the main path, 4 rounds off, then the same 4 on, from one init
    # and stream, in lockstep; cuDNN deterministic, so that the two arms
    # differ only by telemetry
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    jsonl = tmp / "main.jsonl"
    tel = Telemetry(jsonl=str(jsonl), engine="sim")
    arms = {"off": sim({}), "on": sim({}, tel)}
    ms = {"off": [], "on": []}
    launches = {arm: {n: 0 for n in ops.KERNELS} for arm in arms}
    bits = []
    for _ in range(TELEMETRY_ROUNDS):
        for arm, s in arms.items():
            inputs = s.next_round_inputs()
            before = ops.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.run_round(*inputs)
            torch.cuda.synchronize()
            ms[arm].append((time.perf_counter() - t0) * 1e3)
            for n, c in launch_diff(ops, before).items():
                launches[arm][n] += c
        bits.append(all(torch.equal(a, b) for a, b in zip(
            T.leaves(arms["off"].params), T.leaves(arms["on"].params))))
    curve, spans = list(tel.drift_curve), tel.tracer.summary()
    n_events = validate_jsonl(str(jsonl))
    off_params = T.tree_map(lambda t: t.clone(), arms["off"].params)
    # one more round each under the profiler: the enabled round's extra
    # device launches, and each arm's idle share
    events = {}
    for arm, s in arms.items():
        inputs = s.next_round_inputs()
        wall_ms, rows, busy_ms = profiled(torch, lambda: s.run_round(*inputs))
        events[arm] = sum(count for _, _, count in rows)
        idle_share(f"telemetry (a) {arm} profile", "round", wall_ms, rows,
                   busy_ms, sorted(ms[arm][1:])[1], 6)
    tel.close()
    # the first round pays the arm that runs first its warm-ups
    off, on = sum(ms["off"][1:]), sum(ms["on"][1:])
    log(f"telemetry (a): 4 main-path rounds off {ms['off']} ms, on "
        f"{ms['on']} ms; rounds 2-4 {off:.3f} / {on:.3f} ms, ratio on/off "
        f"{on / off:.4f}; device events of a profiled round off "
        f"{events['off']}, on {events['on']} (extra "
        f"{events['on'] - events['off']})")
    log(f"telemetry (a): parameters bit for bit after each round {bits}; "
        f"launches off {launches['off']}, on {launches['on']}")
    log(f"telemetry (a): drift curve {curve}; spans {spans}; {n_events} "
        f"JSONL events valid")
    if not (all(bits) and launches["off"] == launches["on"]
            and min(launches["on"][n] for n in ("fused_axpy", "server_update",
                                                "weighted_reduce")) > 0
            and [set(d) - {"round"} for d in curve]
            == [DRIFT_KEYS] * TELEMETRY_ROUNDS
            and [d["round"] for d in curve] == list(range(TELEMETRY_ROUNDS))
            and all(math.isfinite(v) for d in curve for v in d.values())
            and spans["round"]["count"] == TELEMETRY_ROUNDS
            and n_events == TELEMETRY_ROUNDS):
        raise AssertionError("telemetry (a): the enabled main path differs "
                             "from the disabled one, or its record is wrong")
    # a third run at the library's default cuDNN settings, against the
    # disabled arm's 4 rounds
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = cudnn
    third = sim({})
    for _ in range(TELEMETRY_ROUNDS):
        third.run_round(*third.next_round_inputs())
    same = all(torch.equal(a, b) for a, b in zip(T.leaves(third.params),
                                                 T.leaves(off_params)))
    log(f"telemetry (a): a third run at cuDNN's default settings equals the "
        f"deterministic disabled one bit for bit after 4 rounds: {same}")
    del arms, third, off_params

    # (b) top-k 10% + EF, dense and sparse, one round each; then one
    # one-step round of each from the same state on the card and on the CPU
    # (TF32 off), drift within phase 3's one-step bar
    for tag in ("a_topk_dense", "b_topk_sparse"):
        t = Telemetry(engine="sim")
        s = sim(WIRES[tag], t, rounds=1)
        s.run_round(*s.next_round_inputs())
        d = t.drift_curve[-1]
        log(f"telemetry (b) {tag}: one round's drift {d}")
        if set(d) - {"round"} != DRIFT_KEYS | {"ef_residual_norm"}:
            raise AssertionError(f"telemetry (b) {tag}: drift keys {set(d)}")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for tag in ("a_topk_dense", "b_topk_sparse"):
            curves = {}
            for device in ("cuda", "cpu"):
                t = Telemetry(engine="sim")
                s = sim(dict(WIRES[tag], local_steps=1), t, device=device,
                        rounds=1)
                s.run_round(*s.next_round_inputs())
                curves[device] = t.drift_curve[-1]
            err = drift_rel_err(curves["cuda"], curves["cpu"])
            log(f"telemetry (b) {tag}, one step: card {curves['cuda']}, CPU "
                f"{curves['cpu']}: largest relative difference {err} "
                f"(bar 1e-4)")
            if not err <= 1e-4:
                raise AssertionError(f"telemetry (b) {tag}: card and CPU "
                                     f"drift disagree")
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            cudnn

    # (c) the semi-async engine: phase 10's fleet and wire, 4 flushes
    t = Telemetry(engine="async")
    e = AsyncFederatedSimulator(
        FedConfig(eta=ETA, buffer_k=4, **ASYNC_WIRES["a_topk_unicast"]),
        SimConfig(model="cnn", n_classes=10, rounds=TELEMETRY_ROUNDS,
                  eval_every=TELEMETRY_ROUNDS, cnn_width=32, seed=19),
        HeteroConfig(**ASYNC_HETERO), x, y, xt, yt, parts,
        params=T.tree_map(lambda p: p.clone(), params0), telemetry=t)
    before = ops.launch_counts()
    e.run()
    counts = launch_diff(ops, before)
    want, n_groups = expected_async_launches(e, n_leaves, False)
    version, buffer, stale = 0, [], []
    for kind, _, _, v in e.event_log:
        if kind == "arrive":
            buffer.append(version - v)
        elif kind == "update":
            stale.append((sum(buffer) / len(buffer), float(max(buffer))))
            version, buffer = v, []
    got = [(d["staleness_mean"], d["staleness_max"]) for d in t.drift_curve]
    spans = t.tracer.summary()
    broadcasts = len({v for v, _ in dispatch_waves(e)})
    log(f"telemetry (c): {len(t.drift_curve)} flush records {list(t.drift_curve)}; "
        f"staleness from the event log {stale}; spans {spans}; dispatch "
        f"groups {n_groups}, broadcasts {broadcasts}; launches {counts}, "
        f"expected {want}")
    if not ([d["round"] for d in t.drift_curve]
            == list(range(1, TELEMETRY_ROUNDS + 1)) and got == stale
            and spans["aggregate"]["count"] == TELEMETRY_ROUNDS
            and spans["local_train"]["count"] == sum(n_groups.values())
            and spans["transport.encode"]["count"] == broadcasts
            and counts == want):
        raise AssertionError("telemetry (c): the async engine's record "
                             "differs from its event log")

    # (d) serving: the TINY engine of serving_bench, 8 requests
    jsonl = tmp / "serving.jsonl"
    t = Telemetry(jsonl=str(jsonl), engine="serving")
    eng = ServingEngine(serving_bench.TINY,
                        params=serving_bench.init_params("cuda"),
                        sched=SchedulerConfig(n_slots=4,
                                              max_len=serving_bench.MAX_LEN,
                                              prefill_chunk=16, page_size=32),
                        telemetry=t, device="cuda")
    for p in serving_bench.make_requests(8):
        eng.add_request(p, max_new_tokens=serving_bench.GEN)
    outs = eng.run()
    t.close()
    n_valid = validate_jsonl(str(jsonl))
    kinds = [json.loads(line)["kind"] for line in
             jsonl.read_text().splitlines()]
    tokens = sum(len(o.tokens) for o in outs)
    c = t.counters.snapshot()
    log(f"telemetry (d): {len(outs)} requests, {tokens} tokens; events "
        f"{ {k: kinds.count(k) for k in set(kinds)} } ({n_valid} valid); "
        f"counters {c}; spans {t.tracer.summary()}")
    if not (kinds.count("request") == len(outs) == 8
            and kinds.count("summary") == 1
            and c["serving.tokens_generated"] == tokens
            and c["serving.requests_finished"] == 8
            and c["serving.steps"] == eng.n_steps
            and c["serving.queue_depth"] == c["serving.slots_occupied"] == 0):
        raise AssertionError("telemetry (d): the serving record is wrong")

    # (e) telemetry_bench and comm_sweep at cut rounds, cuDNN
    # deterministic: their accuracy booleans compare runs that differ only
    # by telemetry or by a lossless wire
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        tb = importlib.import_module("repro_torch.benchmarks.telemetry_bench")
        log(f"telemetry (e): telemetry_bench cut to {TELEMETRY_CUTS} (its "
            f"own: rounds 40, warm-up 4)")
        rows, t0 = [], time.perf_counter()
        out = tmp / "BENCH_telemetry_torch.json"
        try:
            tb.main(rows, out_json=str(out), device="cuda", **TELEMETRY_CUTS)
        except AssertionError as err:
            # the 5% budget is the full run's to judge; at 10 rounds it is
            # logged, and only the accuracy's assertion fails the phase
            if not json.loads(out.read_text())["enabled_acc_identical"]:
                raise
            log(f"telemetry (e): telemetry_bench at cut rounds: {err}")
        report = json.loads(out.read_text())
        log(f"telemetry (e): telemetry_bench {time.perf_counter() - t0:.1f} "
            f"s, rows {rows}, report {report}")
        if [r.split(",")[0] for r in rows] != BENCH_ROWS["telemetry_bench"] \
                or not report["enabled_acc_identical"]:
            raise AssertionError("telemetry (e): telemetry_bench's rows "
                                 "differ or telemetry changed the accuracy")
        cs = importlib.import_module("repro_torch.benchmarks.comm_sweep")
        sims = []
        run_fl, run_fl_async = cs.run_fl, cs.run_fl_async

        def keep(fn):
            def wrapped(*a, **k):
                r = fn(*a, **k)
                sims.append(r["sim"])
                return r
            return wrapped
        cs.run_fl, cs.run_fl_async = keep(run_fl), keep(run_fl_async)
        log(f"telemetry (e): comm_sweep cut to {COMM_CUTS} (its own: 90, "
            f"80, 40)")
        rows, t0 = [], time.perf_counter()
        out = tmp / "BENCH_comm_torch.json"
        try:
            cs.main(rows, out_json=str(out), device="cuda", **COMM_CUTS)
        finally:
            cs.run_fl, cs.run_fl_async = run_fl, run_fl_async
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = \
            cudnn
    report = json.loads(out.read_text())
    # the cells in the driver's call order: sync, async, intermittent,
    # then the downlink cells after the reused down_none
    cells = (report["cells"] + report["async_cells"]
             + report["intermittent_cells"] + report["downlink_cells"][1:])
    mismatch = []
    for cell, s in zip(cells, sims):
        want, waves = predicted_bytes(s)
        if "availability" in cell:
            _, n_catch, n_resync = unicast_classes(s.fed.resync_horizon,
                                                   waves)
            want.pop("uplink_bytes")
            want.pop("uplink_bytes_raw")
            want.update(catchups=n_catch, resyncs=n_resync,
                        catchup_bytes=n_catch * s.transport._down_nbytes,
                        resync_bytes=n_resync * s.transport._down_raw)
        mismatch += [(k, cell[k], v) for k, v in want.items()
                     if cell[k] != v]
    head = report["headline"]
    inter = {(c["availability"], c["resync_horizon"]): c
             for c in report["intermittent_cells"]}
    log(f"telemetry (e): comm_sweep {time.perf_counter() - t0:.1f} s, "
        f"{len(sims)} runs, rows {rows}")
    log(f"telemetry (e): comm_sweep headline {head}; drift {report['drift']}; "
        f"byte fields differing from their prediction: {mismatch}")
    if not ([r.split(",")[0] for r in rows] == BENCH_ROWS["comm_sweep"]
            and len(sims) == len(cells) == 24 and not mismatch
            and head["downlink_delta_lossless"]
            and all(inter[(av, 0)]["acc"] == inter[(av, 4)]["acc"]
                    for av in (1.0, 0.5))):
        raise AssertionError("telemetry (e): comm_sweep's rows, bytes or "
                             "lossless accuracies are wrong")


# -- phase 14: the rest of the LM stack at full width -----------------------
INTERNVL, SCOUT, DEEPSEEK = ("internvl2-26b", "llama4-scout-17b-a16e",
                             "deepseek-v3-671b")
WHISPER, XLSTM = "whisper-small", "xlstm-350m"
ARCH_DEPTH = {SCOUT: 4, DEEPSEEK: 4}    # one card holds neither MoE whole


def arch_config(name):
    """The full-width config phase 14 runs: the two MoE models cut in
    depth (Scout to one period of its 3 windowed : 1 global interleave,
    DeepSeek-V3 to its three dense MLA layers and one MoE layer)."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    cfg = get_arch(name)
    return replace(cfg, n_layers=ARCH_DEPTH[name]) if name in ARCH_DEPTH \
        else cfg


def dropless(cfg):
    """The smallest capacity factor at which no assignment can drop: an
    expert's cap = T·k·cf / E slots then hold all T tokens.  The reference's
    8.0 is dropless at its test's 4 experts top-2, not at Scout's 16 top-1
    or DeepSeek-V3's 256 top-8, whose random routers send most tokens to
    a few experts."""
    from dataclasses import replace
    m = cfg.moe
    return replace(cfg, moe=replace(m, capacity_factor=m.n_experts / m.top_k))


class RouteLog:
    """Records every routing call while on: each (token, choice)
    assignment's expert, which were kept, and each token's gap between its
    k-th and (k+1)-th router probabilities (top-1: its two highest)."""

    def __init__(self, torch):
        from repro_torch.models import layers as L
        from repro_torch.models import moe as MOE
        self.torch, self.L, self.MOE, self.calls = torch, L, MOE, []

    def __enter__(self):
        route = self.route = self.MOE.route

        def recording(p, xt, cfg):
            out = route(p, xt, cfg)
            k = cfg.moe.top_k
            probs = self.torch.softmax(self.L.linear(p["router"], xt.float()),
                                       -1)
            top = probs.topk(k + 1, dim=-1).values
            self.calls.append({"e": out[0], "keep": out[3],
                               "gap": top[:, k - 1] - top[:, k]})
            return out
        self.MOE.route = recording
        return self

    def __exit__(self, *exc):
        self.MOE.route = self.route


def route_flips(a, b, top_k):
    """(layer, token, gap) of each token whose assignments differ between
    two RouteLogs of the same forward."""
    flips = []
    for layer, (ca, cb) in enumerate(zip(a.calls, b.calls)):
        diff = (ca["e"] != cb["e"]).reshape(-1, top_k).any(-1)
        for tok in diff.nonzero().flatten().tolist():
            flips.append((layer, tok, ca["gap"][tok].item()))
    return flips


def decode_against(torch, model, p, cfg, toks, full, steps, tag, cache=None):
    """``steps`` decode steps from position 0 against the forward's logits
    ``full`` (B, >= steps, V) at the reference's bar (atol 2e-2 + rtol
    2e-2, tests/test_archs_smoke.py) -> (decode logits (B, steps, V), the
    largest excess over the bar)."""
    if cache is None:
        cache = model.init_cache(cfg, toks.shape[0], steps, torch.float32,
                                 device=toks.device)
    outs = []
    for t in range(steps):
        lg, cache = model.decode_step(p, cache, toks[:, t:t + 1], t, cfg)
        outs.append(lg.float())
    dec = torch.stack(outs, 1)
    want = full[:, :steps].float()
    excess = ((dec - want).abs() - 2e-2 - 2e-2 * want.abs()).max().item()
    log(f"{tag}: {steps} decode steps against the forward: max |decode - "
        f"forward| = {(dec - full[:, :steps]).abs().max().item()}, excess "
        f"over 2e-2 abs + rel {excess}")
    return dec, excess


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def loaded(torch, name, cfg, count_params, dtype=None):
    """Initialise ``cfg`` on the card from seed 0 with the peak reset."""
    from repro_torch.models.registry import get_model
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = get_model(cfg)
    kw = {} if dtype is None else {"dtype": dtype}
    p, s = timed(torch, lambda: model.init(0, cfg, device="cuda", **kw))
    log(f"archs {name}: {cfg.n_layers} layers, {count_params(cfg)} "
        f"parameters, {str(dtype or torch.float32)[6:]}, init on the card "
        f"in {s:.2f}s, peak {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    return model, p


def peak(torch):
    return f"peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"


def rel_last(got, want):
    scale = want.abs().max().item()
    return (got - want).abs().max().item() / scale, scale


def archs_phase(torch, np):
    """(a) internvl2-26b whole in bf16, (b) llama4-scout at depth 4, (c)
    deepseek-v3 at depth 4, (d) whisper-small, (e) xlstm-350m, each at full
    width from seed 0 -> the flash launches of the kernel-route forwards."""
    from repro_torch.core import tree as T
    from repro_torch.kernels import ops
    from repro_torch.models import encdec as E
    from repro_torch.models import xlstm as XL
    from repro_torch.models.registry import count_params
    from repro_torch.models.transformer import VIS_EMBED_DIM
    from repro_torch.serving import (SchedulerConfig, ServingEngine,
                                     latency_summary)
    totals = {"ssd_scan": 0, "flash_attention": 0}

    def routes(tag, model, p, cfg, batch, n_flash, bar):
        """The kernel route (counted) and the plain route, each run twice
        and timed the second time: last-position logits, aux loss, seconds,
        and each route's RouteLog."""
        def kernel_route():
            return counted_forward(ops, lambda: model.forward(
                p, batch, cfg, True, logits_slice="last"), 0, n_flash,
                totals, tag)

        def plain_route():
            ops.reset_launch_counts()
            out = model.forward(p, batch, cfg, False, logits_slice="last")
            if any(ops.launch_counts().values()):
                raise AssertionError(f"{tag}: the plain route launched "
                                     f"{ops.launch_counts()}")
            return out
        kernel_route()
        with RouteLog(torch) as rk:
            (lk, ak), sk = timed(torch, kernel_route)
        plain_route()
        with RouteLog(torch) as rp:
            (lp, ap), sp = timed(torch, plain_route)
        lk, lp = lk[:, -1].float(), lp[:, -1].float()
        if not (torch.isfinite(lk).all() and lk.shape == lp.shape):
            raise AssertionError(f"{tag}: bad logits {lk.shape}")
        err, scale = rel_last(lk, lp)
        log(f"{tag}: kernel route {sk:.3f}s ({n_flash} flash launches), "
            f"plain route {sp:.3f}s; last-position logits max |kernel - "
            f"plain| = {err} of max |logit| {scale} (bar {bar}); aux "
            f"{float(ak)} / {float(ap)}; {peak(torch)}")
        return err, float(ak), float(ap), rk, rp

    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)

    # (a) internvl2-26b, whole, bf16: the VLM prefix and 48 flash launches
    cfg = arch_config(INTERNVL)
    model, p = loaded(torch, INTERNVL, cfg, count_params, torch.bfloat16)
    rng = np.random.RandomState(0)
    n_txt = 2048 - cfg.n_patch_tokens
    batch = {"tokens": torch.from_numpy(rng.randint(
        0, cfg.vocab_size, (1, n_txt))).cuda(),
        "patch_embeds": torch.from_numpy(rng.randn(
            1, cfg.n_patch_tokens, VIS_EMBED_DIM).astype(np.float32)).cuda()}
    err = routes(f"archs (a) {INTERNVL} bf16 B 1 L {cfg.n_patch_tokens} + "
                 f"{n_txt}", model, p, cfg, batch, cfg.n_layers, 5e-2)[0]
    if not err <= 5e-2:
        raise AssertionError("archs (a): the routes' logits differ")
    del p, batch

    # the fp32 models: TF32 off
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # (b) llama4-scout, depth 4: layers 0-2 windowed (masked route), 3 global
    cfg = arch_config(SCOUT)
    model, p = loaded(torch, SCOUT, cfg, count_params)
    n_global = sum(not cfg.layer_uses_window(i) for i in range(cfg.n_layers))
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 2048))).cuda()
    tag = f"archs (b) {SCOUT} depth {cfg.n_layers} B 2 L 2048"
    err, ak, ap, rk, rp = routes(tag, model, p, cfg, {"tokens": toks},
                                 n_global, 1e-3)
    flips = route_flips(rk, rp, cfg.moe.top_k)
    drops = sum((~c["keep"]).sum().item() for c in rk.calls)
    log(f"{tag}: {drops} assignments dropped at capacity "
        f"{cfg.moe.capacity_factor}; {len(flips)} tokens assigned "
        f"differently by the two routes {flips[:8]}")
    if flips:
        if not all(gap < 1e-5 for _, _, gap in flips):
            raise AssertionError(f"{tag}: routes part above a near-tie")
        err, ak, ap, rk, rp = routes(tag + " dropless", model, p,
                                     dropless(cfg), {"tokens": toks},
                                     n_global, 1e-3)
        log(f"{tag} dropless: {len(route_flips(rk, rp, 1))} tokens "
            f"assigned differently")
    if not (err <= 1e-3 and abs(ak - ap) <= 1e-5 * abs(ap)):
        raise AssertionError(f"{tag}: the routes' logits or aux differ")
    cfg_d = dropless(cfg)
    t16 = toks[:1, :16]
    with RouteLog(torch) as rl:
        full = model.forward(p, {"tokens": t16}, cfg_d)[0]
    if not all(c["keep"].all() for c in rl.calls):
        raise AssertionError(f"{tag}: the dropless capacity dropped")
    if decode_against(torch, model, p, cfg_d, t16, full, 16,
                      f"archs (b) {SCOUT} capacity "
                      f"{cfg_d.moe.capacity_factor}")[1] > 0:
        raise AssertionError("archs (b): decode departs from the forward")
    del full
    eng = ServingEngine(cfg, p, SchedulerConfig(n_slots=4, max_len=48,
                                                prefill_chunk=16),
                        device="cuda")
    rng = np.random.RandomState(2)
    for _ in range(8):
        eng.add_request(rng.randint(0, cfg.vocab_size, 32).tolist(), 16)
    outs, wall = timed(torch, eng.run)
    n_tok = sum(len(o.tokens) for o in outs)
    lat = latency_summary(outs)
    log(f"archs (b) {SCOUT} engine: {len(outs)} requests on 4 slots, "
        f"capacity {cfg.moe.capacity_factor}, {n_tok} tokens in {wall:.3f}s "
        f"({n_tok / wall:.2f} tok/s), {eng.n_steps} engine steps; TTFT p50 "
        f"{lat['ttft_s']['p50']}s, e2e p50 {lat['e2e_s']['p50']}s; "
        f"{peak(torch)}")
    if len(outs) != 8 or any(len(o.tokens) != 16 for o in outs):
        raise AssertionError("archs (b): engine requests unfinished")
    del p, eng, outs, toks

    # (c) deepseek-v3, depth 4: MLA (never the kernel) and 256 experts
    cfg = arch_config(DEEPSEEK)
    model, p = loaded(torch, DEEPSEEK, cfg, count_params)
    toks = torch.from_numpy(np.random.RandomState(3).randint(
        0, cfg.vocab_size, (1, 1024))).cuda()
    tag = f"archs (c) {DEEPSEEK} depth {cfg.n_layers} B 1 L 1024"

    def prefill():
        return counted_forward(ops, lambda: model.forward(
            p, {"tokens": toks}, cfg, True, logits_slice="last"), 0, 0,
            totals, tag)
    prefill()
    with RouteLog(torch) as rl:
        (last, aux), s = timed(torch, prefill)
    drops = sum((~c["keep"]).sum().item() for c in rl.calls)
    if not torch.isfinite(last).all():
        raise AssertionError(f"{tag}: non-finite logits")
    log(f"{tag}: prefill (use_pallas=True, 0 flash launches) {s:.3f}s, aux "
        f"{float(aux)}, {drops} assignments dropped at capacity "
        f"{cfg.moe.capacity_factor}; {peak(torch)}")
    # decode against the forward of its 16 tokens, both dropless
    cfg_d = dropless(cfg)
    with RouteLog(torch) as rl:
        full = model.forward(p, {"tokens": toks[:, :16]}, cfg_d)[0]
    if not all(c["keep"].all() for c in rl.calls):
        raise AssertionError(f"{tag}: the dropless capacity dropped")
    if decode_against(torch, model, p, cfg_d, toks, full, 16,
                      f"archs (c) {DEEPSEEK} absorbed MLA, capacity "
                      f"{cfg_d.moe.capacity_factor}")[1] > 0:
        raise AssertionError("archs (c): decode departs from the forward")
    del p, full, toks, last

    # (d) whisper-small: encoder 1500 frames, decoder 64 tokens
    cfg = arch_config(WHISPER)
    model, p = loaded(torch, WHISPER, cfg, count_params)
    p_cpu = T.tree_map(lambda t: t.cpu(), p)
    rng = np.random.RandomState(4)
    frames = torch.from_numpy(rng.randn(1, 1500, cfg.d_model).astype(
        np.float32))
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (1, 64)))
    card, s = timed(torch, lambda: model.forward(
        p, {"frames": frames.cuda(), "tokens": toks.cuda()}, cfg)[0])
    t0 = time.perf_counter()
    cpu = model.forward(p_cpu, {"frames": frames, "tokens": toks}, cfg)[0]
    err, scale = rel_last(card.float().cpu(), cpu)
    log(f"archs (d) {WHISPER} B 1, 1500 frames, 64 tokens: forward "
        f"{s:.3f}s on the card ({time.perf_counter() - t0:.1f}s on the "
        f"CPU); max |logit card - cpu| = {err} of max |logit| {scale} (bar "
        f"1e-3); {peak(torch)}")
    if not err <= 1e-3:
        raise AssertionError("archs (d): card and CPU disagree")
    cache = model.init_cache(cfg, 1, 1500, torch.float32, device="cuda")
    cache = E.prefill_cross(p, E.encode(p, frames.cuda(), cfg), cfg, cache)
    if decode_against(torch, model, p, cfg, toks.cuda(), card, 16,
                      f"archs (d) {WHISPER} after prefill_cross",
                      cache=cache)[1] > 0:
        raise AssertionError("archs (d): decode departs from the forward")
    del p, p_cpu, cache, card

    # (e) xlstm-350m: 18 mLSTM and 6 sLSTM blocks
    cfg = arch_config(XLSTM)
    model, p = loaded(torch, XLSTM, cfg, count_params)
    p_cpu = T.tree_map(lambda t: t.cpu(), p)
    toks = torch.from_numpy(np.random.RandomState(5).randint(
        0, cfg.vocab_size, (1, 512)))
    slstm_s = []
    slstm = XL.slstm_forward

    def timed_slstm(*a):
        out, s = timed(torch, lambda: slstm(*a))
        slstm_s.append(s)
        return out
    XL.slstm_forward = timed_slstm
    try:
        card, s = timed(torch, lambda: model.forward(
            p, {"tokens": toks.cuda()}, cfg)[0])
    finally:
        XL.slstm_forward = slstm
    cpu = model.forward(p_cpu, {"tokens": toks}, cfg)[0]
    err, scale = rel_last(card.float().cpu(), cpu)
    log(f"archs (e) {XLSTM} B 1 L 512: forward {s:.3f}s on the card, the "
        f"{len(slstm_s)} sLSTM blocks' loops {sum(slstm_s):.3f}s of it "
        f"({sum(slstm_s) / s:.3f}); max |logit card - cpu| = {err} of max "
        f"|logit| {scale} (bar 1e-3); {peak(torch)}")
    if not err <= 1e-3:
        raise AssertionError("archs (e): card and CPU disagree")
    t32 = toks[:, :32]
    full = model.forward(p, {"tokens": t32.cuda()}, cfg)[0]
    dec, gap = decode_against(torch, model, p, cfg, t32.cuda(), full, 32,
                              f"archs (e) {XLSTM} whole (sLSTM norm spans the "
                              f"forward's sequence)")
    cpu_full = model.forward(p_cpu, {"tokens": t32}, cfg)[0]
    cpu_dec, cpu_gap = decode_against(torch, model, p_cpu, cfg, t32,
                                      cpu_full, 32, f"archs (e) {XLSTM} "
                                      f"whole on the CPU")
    err, scale = rel_last(dec.cpu(), cpu_dec)
    log(f"archs (e): decode card vs CPU max |logit| diff {err} of {scale} "
        f"(bar 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("archs (e): card and CPU decode disagree")
    # the mLSTM prefix (blocks 0-2, one run): causal, so decode is the
    # forward's prefix
    from dataclasses import replace
    head = replace(cfg, n_layers=3, block_pattern=cfg.block_pattern[:3])
    ph = {"embed": p["embed"], "runs": {"0": p["runs"]["0"]},
          "final_norm": p["final_norm"]}
    full = model.forward(ph, {"tokens": t32.cuda()}, head)[0]
    if decode_against(torch, model, ph, head, t32.cuda(), full, 32,
                      f"archs (e) {XLSTM} mLSTM blocks 0-2")[1] > 0:
        raise AssertionError("archs (e): decode departs from the forward")
    del p, p_cpu, ph, full, card
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    log(f"archs: kernel launches of the kernel-route forwards {totals}")
    return totals


# ---------------------------------------------------------------------------
# phase 15: the pod engine
# ---------------------------------------------------------------------------
POD_DEVICE = "cuda"
POD_SHAPE = {"CS": 4, "H": 2, "b": 2, "L": 2048}   # (a)-(c), zamba2 full width
POD_ETA = 0.01
POD_FLEET = 8            # (c): the EF store's clients
POD_FINETUNE_ROUNDS = 10  # (f): pod_finetune's --rounds, cut from 150
POD_LM_ROUNDS = 30       # (f): lm_round's ROUNDS, cut from 60
POD_KERNELS = ("fused_axpy", "local_update", "server_update",
               "weighted_reduce", "threshold_select", "qsgd", "kd_loss",
               "kd_loss_bwd")


def pod_run_configs():
    """(a)'s FedConfig and RunConfig: the mixed FedADC round."""
    from repro_torch.configs.base import FedConfig, RunConfig
    return (FedConfig(strategy="fedadc", variant="nesterov",
                      local_steps=POD_SHAPE["H"],
                      clients_per_round=POD_SHAPE["CS"], eta=POD_ETA),
            RunConfig(remat="full"))


def pod_config():
    from repro_torch.configs import get_arch
    return get_arch(ZAMBA)


def pod_batch(torch, np, tokens, r, CP=1, CS=None, H=None, b=None,
              ids=None):
    """Round r's batch (CP, CS, H, b, L): the next CP·CS·H·b documents of
    ``tokens`` (L + 1 long), labels the tokens shifted by one, on the
    card."""
    CS = POD_SHAPE["CS"] if CS is None else CS
    H = POD_SHAPE["H"] if H is None else H
    b = POD_SHAPE["b"] if b is None else b
    n = CP * CS * H * b
    sel = (np.arange(n) + r * n) % len(tokens)
    bt = torch.from_numpy(tokens[sel].reshape(CP, CS, H, b, -1)).to(
        POD_DEVICE)
    batch = {"tokens": bt[..., :-1].contiguous(),
             "labels": bt[..., 1:].contiguous()}
    if ids is not None:
        batch["client_ids"] = torch.tensor(ids, dtype=torch.int32,
                                           device=POD_DEVICE).reshape(CP, CS)
    return batch


def check_launches(tag, got, want):
    got = {n: got[n] for n in want}
    log(f"pod {tag}: launches {got}, predicted {want}")
    if got != want:
        raise AssertionError(f"pod {tag}: launches differ from the "
                             f"prediction")


def pod_finite(torch, T, tree):
    return all(bool(torch.isfinite(x).all()) for x in T.leaves(tree))


def pod_update_err(torch, T, got, want, start):
    """max |got − want| / max |want − start| over a tree."""
    num = max(float((a.float().cpu() - b.float().cpu()).abs().max())
              for a, b in zip(T.leaves(got), T.leaves(want)))
    den = max(float((a.float().cpu() - b.float().cpu()).abs().max())
              for a, b in zip(T.leaves(want), T.leaves(start)))
    return num / den


def wire_formula(T, params):
    """One client's top-k uplink bytes, from the leaf sizes: per leaf k
    bf16 values, k indices of ⌈log2 n⌉ bits and a 32-bit header."""
    bits = 0
    for x in T.leaves(params):
        n = x.numel()
        idx = max(1, math.ceil(math.log2(n))) if n > 1 else 1
        bits += topk_k(n) * (16 + idx) + 32
    return (bits + 7) // 8


def _rebuild(T, tree, outs):
    """``outs`` (in leaf order) placed in a tree of ``tree``'s structure."""
    it = iter(outs)
    return T.tree_map(lambda _: next(it), tree)


def set_aside(ops, aside, fn):
    """Run fn; the launches it makes (checks against plain versions,
    timings) are added to ``aside``, which the phase leaves out of its
    main-path counts -> fn's result."""
    mark = ops.launch_counts()
    out = fn()
    for n, c in launch_diff(ops, mark).items():
        aside[n] = aside.get(n, 0) + c
    return out


def pod_kernel_checks(torch, T, ops, params, m, fed, tag):
    """The six update and wire kernels of the pod path against their plain
    versions (``kernels.ref``) on the card, leaf by leaf and bit for bit as
    in phase 1, over the leaf table of ``params`` (a round's fp32 master θ;
    ``m`` its fp32 momentum), each through the ``ops`` sweep the engine
    calls and on the operands it gives it: the nesterov half-step and the
    heavy-ball step on the bf16 local θ (1, ...) with the bf16 m̄ and a
    bf16 gradient; the server step on the fp32 master with an fp32 Δ̄ at
    scale 1/η; the recombine of one fp32 pod row (1, ...); the top-k select
    and QSGD (at the uplink's and the downlink's levels) on one bf16 client
    row (1, ...), the delta η·m."""
    from repro_torch.kernels import ref
    bf16, eta, dev = torch.bfloat16, fed.eta, T.leaves(params)[0].device
    gen = torch.Generator(device=dev).manual_seed(25)

    def check(name, what, got, plain):
        bad = 0
        for i, g in enumerate(got):
            w = plain(i)
            pairs = zip(g, w) if isinstance(g, tuple) else [(g, w)]
            bad += not all(a.dtype == b.dtype and torch.equal(a, b)
                           for a, b in pairs)
        log(f"pod {tag} check {name} ({what}) over {len(got)} leaves: "
            f"{bad} leaves differ from the plain version")
        if bad:
            raise AssertionError(f"pod {tag}: {name} differs from its plain "
                                 f"version")

    def one(tree, dtype):
        return T.tree_map(lambda x: x.to(dtype).unsqueeze(0), tree)
    th = one(params, bf16)
    mb = one(T.tree_map(lambda x: x * (fed.beta_local / fed.local_steps), m),
             bf16)
    xs, ms = T.leaves(th), T.leaves(mb)
    check("fused_axpy", "bf16 θ + (−η)·m̄",
          T.leaves(ops.fused_axpy_tree(th, mb, -eta)),
          lambda i: ref.fused_axpy(xs[i], ms[i], -eta))
    gs = [(1e-2 * torch.randn(x.shape, generator=gen, device=dev))
          .to(bf16) for x in xs]
    check("local_update", "bf16 θ − η(g + m̄)",
          T.leaves(ops.fedadc_local_update_tree(th, _rebuild(T, th, gs),
                                                mb, eta)),
          lambda i: ref.fedadc_local_update(xs[i], gs[i], ms[i], eta))
    del th, mb, xs, ms, gs
    d = T.tree_map(lambda x: x * eta, m)
    gamma, ae = fed.beta_global - fed.beta_local, fed.alpha * eta
    new_t, new_m = ops.fedadc_server_update_tree(params, m, d, gamma, ae,
                                                 scale=1.0 / eta)
    ps, mm, ds = T.leaves(params), T.leaves(m), T.leaves(d)
    check("server_update", "fp32 θ, m, Δ̄ at scale 1/η",
          list(zip(T.leaves(new_t), T.leaves(new_m))),
          lambda i: ref.fedadc_server_update(ps[i], mm[i], ds[i], gamma, ae,
                                             1.0 / eta))
    del new_t, new_m
    rows = one(d, torch.float32)
    rs, w = T.leaves(rows), torch.ones(1, device=dev)
    check("weighted_reduce", "one fp32 pod row",
          T.leaves(ops.weighted_delta_reduce_tree(rows, w)),
          lambda i: ref.weighted_delta_reduce(rs[i], w))
    del rows, rs
    v = one(d, bf16)
    del d, ds
    vs = T.leaves(v)
    taus = [torch.topk(x.reshape(1, -1).abs(), topk_k(x[0].numel()),
                       dim=1).values[:, -1] for x in vs]
    q, r = ops.topk_compress_tree(v, _rebuild(T, v, taus))
    check("threshold_select", f"bf16 client row, top-k {TOPK_FRAC}",
          list(zip(T.leaves(q), T.leaves(r))),
          lambda i: ref.topk_threshold_select(vs[i], taus[i]))
    del q, r, taus
    us = [torch.rand(x.shape, generator=gen, device=dev).to(bf16)
          for x in vs]
    down_bits = fed.qsgd_bits if fed.downlink_qsgd_bits is None \
        else fed.downlink_qsgd_bits
    for bits in sorted({fed.qsgd_bits, down_bits}):
        s = (1 << bits) - 1
        q, r = ops.qsgd_compress_tree(v, _rebuild(T, v, us), s)
        check("qsgd", f"bf16 client row, {bits} bits",
              list(zip(T.leaves(q), T.leaves(r))),
              lambda i: ref.qsgd_quantize(
                  vs[i], us[i], torch.amax(vs[i].reshape(1, -1).abs(),
                                           dim=1), s))
        del q, r


def pod_zamba(torch, np, ops, T, PT, FedConfig, tokens, aside):
    """(a) three mixed FedADC rounds of zamba2-1.2b at full width, the
    third under sync debug mode "error", and a fourth profiled, then the
    path's update and wire kernels against their plain versions over its
    leaf table; (b) FedADC+ on the same state, a warm-up round and a
    counted one, and one KD call pair checked against its plain version and
    timed at that round's shape -> the KD timings.  The checks' and
    timings' launches go to ``aside``."""
    import gc
    cfg = pod_config()
    CS, H, b, L = (POD_SHAPE[k] for k in ("CS", "H", "b", "L"))
    fed, run = pod_run_configs()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    alloc0 = torch.cuda.memory_allocated()
    state, s = timed(torch, lambda: PT.init_state(0, cfg, fed, run,
                                                  device=POD_DEVICE))
    # the state's bytes on the card, for phase 16 (b)'s meta count
    state_alloc = torch.cuda.memory_allocated() - alloc0
    leaves = T.leaves(state["params"])
    n_params = sum(x.numel() for x in leaves)
    g = table_groups(len(leaves))
    log(f"pod (a) {ZAMBA}: {n_params} parameters in {len(leaves)} leaves "
        f"({g} leaf-table groups), init {s:.2f}s, {peak(torch)}; CP 1, "
        f"CS {CS}, H {H}, b {b}, L {L}, remat full, bf16 rounds, fp32 "
        f"master")
    step = PT.make_train_step(cfg, fed, run)
    before = ops.launch_counts()
    times = []
    for r in range(3):
        batch = pod_batch(torch, np, tokens, r)
        torch.cuda.synchronize()
        steady = r == 2
        if steady:
            # the reference's steady_state_transfer_guard: any call that
            # waits for the card or reads it back raises
            torch.cuda.set_sync_debug_mode("error")
        t0 = time.perf_counter()
        try:
            new, aux = step(state, batch)
        finally:
            if steady:
                torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        moved = max(float((a.float() - b_.float()).abs().max())
                    for a, b_ in zip(T.leaves(new["params"]),
                                     T.leaves(state["params"])))
        m_max = max(float(x.abs().max()) for x in T.leaves(new["server"]))
        dtypes = {str(x.dtype) for x in T.leaves(new["params"])
                  + T.leaves(new["server"])}
        log(f"pod (a) round {r + 1}: {times[-1]:.3f}s"
            f"{' (sync debug mode error)' if steady else ''}, loss "
            f"{float(aux['loss'])}, max |Δθ| {moved}, max |m| {m_max}, "
            f"dtypes {sorted(dtypes)}, {peak(torch)}")
        if not (dtypes == {"torch.float32"} and moved > 0 and m_max > 0
                and pod_finite(torch, T, new["params"])
                and pod_finite(torch, T, new["server"])
                and math.isfinite(float(aux["loss"]))):
            raise AssertionError(f"pod (a) round {r + 1}: bad state")
        state = new
    median = statistics.median(times[1:])
    log(f"pod (a): median round (rounds 2-3) {median:.3f}s, rounds "
        f"{[round(t, 3) for t in times]}, {peak(torch)}")
    measured = {"median_s": median, "state_alloc": state_alloc,
                "peak": torch.cuda.max_memory_allocated()}
    # a fourth round under the profiler: device time by kernel, idle share
    batch = pod_batch(torch, np, tokens, 3)
    out = {}
    wall, rows, busy = profiled(torch, lambda: out.update(
        zip(("state", "aux"), step(state, batch))), cpu=False)
    state = out["state"]
    idle_share("pod (a) profiled round 4", "round", wall, rows, busy,
               median * 1e3, top=15)
    # the GEMMs by class, for phase 16 (b)'s FLOPs by dtype
    measured["gemm_ms"] = gemm_ms("pod (a) profiled round 4", rows)
    check_launches("(a)", launch_diff(ops, before), {
        "fused_axpy": 4 * CS * H * 2 * g, "server_update": 4 * g,
        "weighted_reduce": 4 * g, "local_update": 0, "kd_loss": 0})
    set_aside(ops, aside, lambda: pod_kernel_checks(
        torch, T, ops, state["params"], state["server"]["m"], fed,
        f"(a) {ZAMBA}"))

    # (b) FedADC+ on the same state
    lam, tau = KD_LAM, KD_TAU
    fed_kd = FedConfig(strategy="fedadc", variant="nesterov", local_steps=H,
                       clients_per_round=CS, eta=POD_ETA, distill=True,
                       distill_lambda=lam, distill_tau=tau)
    step = PT.make_train_step(cfg, fed_kd, run)
    state, aux = step(state, pod_batch(torch, np, tokens, 4))
    torch.cuda.synchronize()
    before = ops.launch_counts()
    (state, aux), s = timed(torch, lambda: step(
        state, pod_batch(torch, np, tokens, 5)))
    log(f"pod (b) FedADC+ (λ {lam}, τ {tau}): round {s:.3f}s after a "
        f"warm-up, loss {float(aux['loss'])}, {peak(torch)}")
    if not (math.isfinite(float(aux["loss"]))
            and pod_finite(torch, T, state["params"])):
        raise AssertionError("pod (b): non-finite")
    check_launches("(b)", launch_diff(ops, before), {
        "fused_axpy": CS * H * 2 * g, "server_update": g,
        "weighted_reduce": g, "kd_loss": CS * H, "kd_loss_bwd": CS * H})
    del state, step, aux
    torch.cuda.empty_cache()
    return set_aside(ops, aside, lambda: kd_pair_times(
        torch, b * (L - 1), cfg.vocab_size)), measured


def kd_pair_times(torch, rows, n_classes):
    """The KD forward and backward at (rows, n_classes) bf16, one group of
    ρ, against their plain versions on the same operands within phase 5's
    bars (forward 1e-5 + 1e-4 |plain|; backward, from the forward's
    statistics, 1e-5 of the gradient's largest magnitude), then the
    CUDA-event ms of the kernel, its plain version, and bounds."""
    from repro_torch.kernels import kd_loss as KD
    from repro_torch.kernels import ref
    gen = torch.Generator().manual_seed(15)
    operands = kd_operands(torch, rows, n_classes, 1, torch.bfloat16, gen)
    s_, t_, y_, rho_, g_ = operands
    got = KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)
    want = ref.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)
    excess = max(((a - b).abs() - 1e-4 * b.abs()).max().item()
                 for a, b in zip(got, want))
    bwd = kd_bwd_check(torch, KD, ref, operands, got[3], KD_TAU)
    log(f"pod (b) check kd_loss ({rows}, {n_classes}) bf16: max |kernel - "
        f"plain| = {max_err([got], [want])} (bar 1e-5 + 1e-4 |plain|, "
        f"excess over rtol {excess}); kd_loss_bwd tau={KD_TAU}: max |kernel "
        f"- plain| = {bwd[0]}, {bwd[1]} of the largest (bar 1e-5), bit for "
        f"bit {bwd[2]}")
    if not (excess <= 1e-5 and bwd[1] <= 1e-5):
        raise AssertionError(f"pod (b): the KD pair at ({rows}, {n_classes}) "
                             f"differs from its plain version")
    stats_ = got[3]
    del got, want
    out = {}
    for name, call, plain in (
            ("kd_loss",
             lambda: KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU),
             lambda: ref.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)),
            ("kd_loss_bwd",
             lambda: KD.kd_loss_bwd(s_, t_, y_, rho_, stats_, g_, KD_LAM,
                                    KD_TAU),
             lambda: ref.kd_loss_bwd(s_, t_, y_, rho_, stats_, g_, KD_LAM,
                                     KD_TAU))):
        b_ms, b_by = kd_bound(name, rows, n_classes, 1, elem_bytes=2)
        out[name] = {"ms": cuda_ms(torch, call, iters=10),
                     "plain_ms": cuda_ms(torch, plain, iters=3, warmup=1),
                     "bound_ms": b_ms, "bound_by": b_by}
        log(f"pod (b) {name} ({rows}, {n_classes}) bf16: "
            f"{json.dumps(out[name])}")
    return out


def pod_wire(torch, np, ops, T, PT, FedConfig, RunConfig, tokens):
    """(c) the wire on zamba2-1.2b at full width with a fleet of
    POD_FLEET: top-k 10% + EF over two rounds on named clients, the EF
    store's untouched rows bit for bit, then one round of the sparse-native
    top-k wire."""
    cfg = pod_config()
    CS, H = POD_SHAPE["CS"], POD_SHAPE["H"]
    run = RunConfig(remat="full")
    for sparse in (False, True):
        fed = FedConfig(strategy="fedadc", variant="nesterov", local_steps=H,
                        clients_per_round=CS, eta=POD_ETA, compressor="topk",
                        topk_frac=TOPK_FRAC, n_clients=POD_FLEET,
                        sparse_uplink=sparse)
        tag = "(c) sparse top-k" if sparse else "(c) top-k + EF"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = PT.init_state(0, cfg, fed, run, device=POD_DEVICE)
        store = state["clients"]["ef"]
        leaves = T.leaves(state["params"])
        g = table_groups(len(leaves))
        log(f"pod {tag}: EF store {POD_FLEET} x bf16, "
            f"{sum(x.numel() * x.element_size() for x in T.leaves(store))}"
            f" bytes, {peak(torch)}")
        step = PT.make_train_step(cfg, fed, run)
        before = ops.launch_counts()
        waves = ([0, 1, 2, 3], [2, 3, 4, 5])[:1 if sparse else 2]
        snap = None
        for r, ids in enumerate(waves):
            (state, aux), s = timed(torch, lambda: step(
                state, pod_batch(torch, np, tokens, 6 + r, ids=ids)))
            step.account_round(CS)
            store = state["clients"]["ef"]
            rows = [sum(int(torch.count_nonzero(x[i])) for x in
                        T.leaves(store)) for i in range(POD_FLEET)]
            log(f"pod {tag} round {r + 1} on clients {ids}: {s:.3f}s, "
                f"loss {float(aux['loss'])}, non-zero entries of each EF "
                f"row {rows}, {peak(torch)}")
            if not (math.isfinite(float(aux["loss"]))
                    and pod_finite(torch, T, state["params"])):
                raise AssertionError(f"pod {tag}: non-finite")
            untouched = [i for i in range(POD_FLEET)
                         if all(i not in w for w in waves[:r + 1])]
            if any(rows[i] for i in untouched) or not all(rows[i] for i in
                                                           ids):
                raise AssertionError(f"pod {tag}: EF rows touched wrongly")
            if r == 0 and len(waves) > 1:
                # rows 0, 1 are not in round 2: keep their bits on the host
                snap = [x[:2].cpu() for x in T.leaves(store)]
                sums = [sum(float(x[i].double().sum()) for x in
                            T.leaves(store)) for i in (2, 3)]
        if snap is not None:
            same = all(torch.equal(x[:2].cpu(), y) for x, y in
                       zip(T.leaves(store), snap))
            now = [sum(float(x[i].double().sum()) for x in T.leaves(store))
                   for i in (2, 3)]
            log(f"pod {tag}: rows 0-1 bit for bit after round 2: {same}; "
                f"rows 2-3 Σ before/after {sums} / {now}")
            if not same or any(a == b_ for a, b_ in zip(sums, now)):
                raise AssertionError(f"pod {tag}: the store's rows")
        per_client = wire_formula(T, state["params"])
        got = step.transport.uplink_bytes
        want = len(waves) * CS * per_client
        log(f"pod {tag}: uplink {got} bytes ({len(waves) * CS} uploads of "
            f"{per_client}), raw {step.transport.uplink_bytes_raw}")
        if got != want:
            raise AssertionError(f"pod {tag}: uplink bytes")
        check_launches(tag, launch_diff(ops, before), {
            "threshold_select": 0 if sparse else len(waves) * CS * g,
            "sparse_reduce": 0, "fused_axpy": len(waves) * CS * H * 2 * g})
        del state, store, step, snap
    torch.cuda.empty_cache()


def pod_variants(torch, np, ops, T, PT, FedConfig, RunConfig, aside):
    """(d) lm_round's model: QSGD up with delta+QSGD down, then the path's
    update and wire kernels against their plain versions over its leaf
    table (launches to ``aside``), heavy-ball, delta unicast counters, CP 2
    against CP 1, one fleet region against flat, telemetry on against off,
    and use_pallas=True refused."""
    from repro_torch.benchmarks import lm_round
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.telemetry import Telemetry
    cfg = lm_round.model_config()
    tokens = make_token_dataset(64, 65, cfg.vocab_size, seed=1)[0]
    CS, H = 4, 4
    mixed = RunConfig(remat="none")
    fp32 = RunConfig(remat="none", compute_dtype="float32")

    def fed(**kw):
        base = dict(strategy="fedadc", local_steps=H, clients_per_round=CS,
                    eta=0.05, n_clients=8)
        base.update(kw)
        return FedConfig(**base)

    def rounds(f, run, n, batches=None, telemetry=None, state=None):
        st = state if state is not None else PT.init_state(
            0, cfg, f, run, device=POD_DEVICE)
        step = PT.make_train_step(cfg, f, run, telemetry=telemetry)
        auxes = []
        for r in range(n):
            batch = batches[r] if batches is not None else pod_batch(
                torch, np, tokens, r, CS=CS, H=H)
            st, aux = step(st, batch)
            auxes.append(aux)
        torch.cuda.synchronize()
        return st, step, auxes

    leaves = T.leaves(PT.state_shapes(cfg, fed(), mixed)["params"])
    g = table_groups(len(leaves))
    before = ops.launch_counts()
    fq = fed(compressor="qsgd", qsgd_bits=4, downlink_compressor="delta+qsgd",
             downlink_qsgd_bits=8)
    st, _, _ = rounds(fq, mixed, 2)
    if "refs" not in st or not pod_finite(torch, T, st["params"]):
        raise AssertionError("pod (d) qsgd: no downlink reference in state")
    check_launches("(d) QSGD + delta+QSGD", launch_diff(ops, before),
                   {"qsgd": 2 * (CS * g + g)})
    set_aside(ops, aside, lambda: pod_kernel_checks(
        torch, T, ops, st["params"], st["server"]["m"], fq,
        "(d) lm_round's model"))
    before = ops.launch_counts()
    st, _, _ = rounds(fed(variant="heavyball"), mixed, 1)
    check_launches("(d) heavy-ball", launch_diff(ops, before),
                   {"local_update": CS * H * g, "fused_axpy": 0})

    # delta unicast: counters against the wire sizes
    f = fed(downlink_compressor="delta", downlink_unicast=True,
            resync_horizon=1, n_clients=6)
    step = PT.make_train_step(cfg, f, mixed)
    for ids in ([0, 1], [1, 2], [0, 5]):
        step.account_round(client_ids=np.array(ids))
    raw_p = sum(x.numel() * 2 for x in leaves)     # bf16 broadcast
    tr = step.transport
    want = {"downlink_bytes": 5 * 2 * raw_p + 1 * raw_p,
            "downlink_bytes_raw": 6 * 2 * raw_p,
            "uplink_bytes": 6 * raw_p, "uplink_bytes_raw": 6 * raw_p,
            "catchups": 1, "resyncs": 5}
    got = {k: getattr(tr, k) for k in list(want)[:4]}
    got.update(catchups=step.refs.catchups, resyncs=step.refs.resyncs)
    log(f"pod (d) delta unicast: {got}, predicted {want}")
    if got != want:
        raise AssertionError("pod (d): unicast counters")

    # CP 2 against CP 1 over the same clients; one region against flat;
    # telemetry on against off (fp32, TF32 off)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    two = [pod_batch(torch, np, tokens, r, CP=2, CS=2, H=H)
           for r in range(2)]
    one = [{k: v.reshape((1, 4) + v.shape[2:]) for k, v in b_.items()}
           for b_ in two]
    start = PT.init_state(0, cfg, fed(), fp32, device=POD_DEVICE)
    p0 = T.tree_map(lambda x: x.clone(), start["params"])
    a, _, _ = rounds(fed(), fp32, 2, two, state=dict(start))
    b1, _, _ = rounds(fed(), fp32, 2, one, state=dict(start))
    err = pod_update_err(torch, T, a["params"], b1["params"], p0)
    log(f"pod (d) CP 2 x CS 2 against CP 1 x CS 4, two rounds: max |Δ| / "
        f"max |Δθ| = {err} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("pod (d): CP 2 and CP 1 disagree")
    r1, _, _ = rounds(fed(fleet_regions=1), fp32, 2, two, state=dict(start))
    same = all(torch.equal(x, y) for x, y in zip(T.leaves(a["params"]),
                                                 T.leaves(r1["params"])))
    on, _, auxes = rounds(fed(), fp32, 2, two, state=dict(start),
                          telemetry=Telemetry(engine="pod"))
    same_tel = all(torch.equal(x, y) for x, y in zip(
        T.leaves(a["params"]), T.leaves(on["params"])))
    scalars = {k: float(v) for k, v in auxes[-1]["telemetry"].items()}
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32
    log(f"pod (d) one fleet region bit for bit flat: {same}; telemetry on "
        f"bit for bit off: {same_tel}, round 2's {scalars}")
    if not (same and same_tel and all(math.isfinite(v) for v in
                                      scalars.values())
            and set(scalars) == {"delta_dispersion", "update_norm",
                                 "momentum_alignment"}):
        raise AssertionError("pod (d): fleet or telemetry")

    # the kernel route refuses a gradient on the card
    step = PT.make_train_step(cfg, fed(use_pallas=True), mixed)
    try:
        step(PT.init_state(0, cfg, fed(), mixed, device=POD_DEVICE),
             pod_batch(torch, np, tokens, 0, CS=CS, H=H))
    except RuntimeError as e:
        if "no backward" not in str(e):
            raise
        log(f"pod (d) use_pallas=True refused: {str(e)[:80]}...")
    else:
        raise AssertionError("pod (d): use_pallas=True trained")


def pod_flips(torch, T, got, want, bar):
    """The most entries of one leaf where got and want differ by more than
    ``bar``."""
    return max(int(((a.float().cpu() - b.float().cpu()).abs() > bar).sum())
               for a, b in zip(T.leaves(got), T.leaves(want)))


def pod_card_vs_cpu(torch, np, T, PT, FedConfig, RunConfig):
    """(e) one round (CS 2, H 2, b 2, L 64, fp32, TF32 off) of qwen3-4b and
    zamba2-1.2b at reduced() on the card and on the CPU from the same
    parameters and tokens, under plain FedADC, FedADC+ (λ KD_LAM, τ KD_TAU,
    one −100 label) and top-k 10% + EF: updates within 1e-4 of max |Δθ|.
    Top-k may select differently where an entry's |v| ties its leaf's k-th
    within the two devices' difference, moving that entry by a whole step:
    there θ and m are held within 1e-4 except at up to 4 entries a leaf (the
    CPU tests' allowance), and the sum η·m' + the clients' mean residual,
    which a flip leaves unchanged (from m = 0 it is the clients' mean Δ),
    within 1e-4 of its largest magnitude everywhere."""
    from repro_torch.configs import get_arch
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    run = RunConfig(remat="none", compute_dtype="float32")
    cases = (("FedADC", {}),
             ("FedADC+", dict(distill=True, distill_lambda=KD_LAM,
                              distill_tau=KD_TAU)),
             ("top-k + EF", dict(compressor="topk", topk_frac=TOPK_FRAC,
                                 n_clients=2)))
    for name in ("qwen3-4b", ZAMBA):
        cfg = get_arch(name).reduced()
        rng = np.random.RandomState(15)
        tok = rng.randint(0, cfg.vocab_size, (1, 2, 2, 2, 65)).astype(
            np.int32)
        for case, kw in cases:
            fed = FedConfig(strategy="fedadc", local_steps=2,
                            clients_per_round=2, eta=0.05, **kw)
            labels = tok[..., 1:].copy()
            if fed.distill:
                labels[0, 1, 0, 1, 5] = -100
            cpu = PT.init_state(0, cfg, fed, run, device="cpu")
            p0 = T.tree_map(lambda x: x.clone(), cpu["params"])
            card = PT.init_state(0, cfg, fed, run, device=POD_DEVICE,
                                 params=cpu["params"])
            outs = []
            for st, dev in ((card, POD_DEVICE), (cpu, "cpu")):
                outs.append(PT.make_train_step(cfg, fed, run)(st, {
                    "tokens": torch.from_numpy(tok[..., :-1]).to(dev),
                    "labels": torch.from_numpy(labels).to(dev)}))
            (sc, ac), (sh, ah) = outs
            err = pod_update_err(torch, T, sc["params"], sh["params"], p0)
            what = (f"pod (e) {name} reduced, {case}, card vs CPU: max "
                    f"|Δθ card − Δθ cpu| / max |Δθ| = {err} (bar 1e-4); loss "
                    f"{float(ac['loss'])} / {float(ah['loss'])}")
            if "clients" not in sh:
                log(what)
                if not err <= 1e-4:
                    raise AssertionError(f"pod (e) {name} {case}: card and "
                                         f"CPU disagree")
                continue
            step_max = max(float((a - b).abs().max()) for a, b in zip(
                T.leaves(sh["params"]), T.leaves(p0)))
            m_max = max(float(x.abs().max())
                        for x in T.leaves(sh["server"]["m"]))
            flips = (pod_flips(torch, T, sc["params"], sh["params"],
                               1e-4 * step_max),
                     pod_flips(torch, T, sc["server"]["m"],
                               sh["server"]["m"], 1e-4 * m_max))

            def kept(st):
                return T.tree_map(
                    lambda m_, e: fed.eta * m_.cpu() + e[:2].cpu().mean(0),
                    st["server"]["m"], st["clients"]["ef"])
            inv_c, inv_h = kept(sc), kept(sh)
            inv = (max(float((a - b).abs().max()) for a, b in zip(
                T.leaves(inv_c), T.leaves(inv_h)))
                / max(float(x.abs().max()) for x in T.leaves(inv_h)))
            log(f"{what}; entries beyond 1e-4 in one leaf (θ, m) {flips} "
                f"(at most 4); η·m' + mean residual: max |card − cpu| / "
                f"max = {inv} (bar 1e-4)")
            if not (max(flips) <= 4 and inv <= 1e-4):
                raise AssertionError(f"pod (e) {name} {case}: card and CPU "
                                     f"disagree")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        tf32


def pod_drivers(torch, T):
    """(f) lm_round.main and pod_finetune (--rounds cut) with a checkpoint
    restored bit for bit."""
    import tempfile

    from repro_torch import pod_finetune
    from repro_torch.benchmarks import lm_round
    from repro_torch.checkpointing import restore_checkpoint
    log(f"pod (f) lm_round cut to {POD_LM_ROUNDS} rounds a strategy (of "
        f"{lm_round.ROUNDS})")
    lm_round.ROUNDS = POD_LM_ROUNDS
    rows, s = timed(torch, lambda: lm_round.main([], device=POD_DEVICE))
    log(f"pod (f) lm_round: {s:.1f}s; rows {rows}")
    losses = [float(r.split(",")[2]) for r in rows[:2]]
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError("pod (f): lm_round's losses")
    with tempfile.TemporaryDirectory() as d:
        state, s = timed(torch, lambda: pod_finetune.main(
            ["--rounds", str(POD_FINETUNE_ROUNDS), "--device", POD_DEVICE,
             "--ckpt-dir", d]))
        back = restore_checkpoint(d, POD_FINETUNE_ROUNDS, state["params"])
        same = all(torch.equal(x, y) for x, y in zip(
            T.leaves(back), T.leaves(state["params"])))
    log(f"pod (f) pod_finetune --rounds {POD_FINETUNE_ROUNDS}: {s:.1f}s, "
        f"checkpoint restored bit for bit: {same}")
    if not same:
        raise AssertionError("pod (f): the checkpoint")


def pod_phase(torch, np):
    """Phase 15: the pod engine (``launch/train.py``) -> (its launches of
    every kernel, the checks' and timing calls' left out; the KD pair's
    timings at zamba2's FedADC+ shape; (a)'s median round seconds and the
    state's bytes on the card)."""
    from repro_torch.configs.base import FedConfig, RunConfig
    from repro_torch.core import tree as T
    from repro_torch.data.synthetic import make_token_dataset
    from repro_torch.kernels import ops
    from repro_torch.launch import train as PT
    cfg = pod_config()
    tokens, _ = make_token_dataset(64, POD_SHAPE["L"] + 1, cfg.vocab_size,
                                   seed=0)
    start = ops.launch_counts()
    aside = {}
    t0 = time.perf_counter()
    kd_times, measured = pod_zamba(torch, np, ops, T, PT, FedConfig, tokens,
                                   aside)
    log(f"pod (a)-(b): {time.perf_counter() - t0:.1f}s")
    for part, fn in (("(c)", lambda: pod_wire(torch, np, ops, T, PT,
                                              FedConfig, RunConfig, tokens)),
                     ("(d)", lambda: pod_variants(torch, np, ops, T, PT,
                                                  FedConfig, RunConfig,
                                                  aside)),
                     ("(e)", lambda: pod_card_vs_cpu(torch, np, T, PT,
                                                     FedConfig, RunConfig)),
                     ("(f)", lambda: pod_drivers(torch, T))):
        t0 = time.perf_counter()
        fn()
        log(f"pod {part}: {time.perf_counter() - t0:.1f}s")
    total = launch_diff(ops, start)
    launches = {n: total[n] - aside.get(n, 0) for n in total}
    log(f"pod: launches over the phase {launches}")
    return launches, kd_times, measured


# phase 16: the launch tooling and the analysis
TOOLS_DRYRUN = [("zamba2-1.2b", shape) for shape in
                ("train_4k", "prefill_32k", "decode_32k", "long_500k")] \
    + [("llama4-scout-17b-a16e", "train_4k")]
TOOLS_TIMEOUT = 600        # seconds for the meta-device processes


def pod_round_counts():
    """Phase 15's mixed round (a) counted on the meta device at its shape
    -> {"flops", "bytes", "flops_by_dtype"}: its FLOPs (also by the
    operands' dtype) and bytes, the round composed from three short ones
    (``dryrun.count_train_round``)."""
    import torch
    from repro_torch.launch import dryrun
    fed, run = pod_run_configs()
    CS, H, b, L = (POD_SHAPE[k] for k in ("CS", "H", "b", "L"))
    batch = {k: torch.empty((1, CS, H, b, L), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    c = dryrun.count_train_round(pod_config(), fed, run, batch)
    return {"flops": c.flops, "bytes": c.bytes,
            "flops_by_dtype": c.flops_by_dtype}


def pod_round_counts_main(src):
    sys.path.insert(0, src)
    print(json.dumps(pod_round_counts()))
    return 0


def allocator_slack(sizes):
    """The most the caching allocator's blocks can exceed these tensors'
    bytes: each block rounds up to 512 B, and a block of the large pool
    (above 1 MiB) is not split for a remainder of 1 MiB or less."""
    return sum(512 if n <= 1 << 20 else (1 << 20) + 512 for n in sizes)


# a dtype of counted matrix-product FLOPs -> the GEMM class that runs it
DTYPE_GEMM_CLASS = {"bfloat16": "tensor cores", "float16": "tensor cores",
                    "float32": "cuda cores"}


def pod_roofline(R, smi, counts, pod_round):
    """Phase 16 (b): the round's counted FLOPs over its median time, by
    operand dtype against that dtype's peak; the least time those FLOPs
    take at the peaks; and, per dtype, the FLOPs over the profiled round's
    GEMM time of the class that runs them, which no peak may be below
    (else the count or the sorting of the GEMMs is wrong)."""
    peaks = R.peaks_for(smi.split(",")[0])
    median = pod_round["median_s"]
    log(f"tools (b) pod round (CP 1 x CS {POD_SHAPE['CS']} x H "
        f"{POD_SHAPE['H']} of B {POD_SHAPE['b']} x L {POD_SHAPE['L']}, "
        f"mixed): {counts['flops']:.6g} FLOP (matrix products) and "
        f"{counts['bytes']:.6g} bytes counted on meta, median round "
        f"{median:.3f}s (phase 15): {counts['flops'] / median / 1e12:.3f} "
        f"TFLOP/s; {peaks.name}; card {smi}")
    least_s = 0.0
    for dtype, flops in sorted(counts["flops_by_dtype"].items()):
        peak = peaks.for_dtype(dtype)
        cls = DTYPE_GEMM_CLASS.get(dtype)
        if peak is None or cls is None:
            raise AssertionError(f"tools (b): no peak for {dtype} products")
        least_s += flops / peak
        gemm_s = pod_round["gemm_ms"][cls] / 1e3
        rate = flops / gemm_s if gemm_s > 0 else float("inf")
        log(f"tools (b)   {dtype}: {flops:.6g} FLOP, "
            f"{flops / median / 1e12:.3f} TFLOP/s over the round, "
            f"{flops / median / peak:.4f} of the {dtype} peak "
            f"({peak / 1e12:g} TFLOP/s); over the profiled round's GEMMs on "
            f"the {cls} ({gemm_s * 1e3:.3f} ms): {rate / 1e12:.3f} TFLOP/s, "
            f"{rate / peak:.4f} of the peak")
        if rate > peak:
            raise AssertionError(f"tools (b): the {dtype} FLOPs exceed the "
                                 f"peak over the {cls}' GEMM time")
    log(f"tools (b)   the counted FLOPs at the peaks take {least_s:.4f}s: "
        f"{least_s / median:.4f} of the median round")


def tools_phase(torch, smi, pod_round):
    """Phase 16: (a) the dry-run and roofline_report, (b) phase 15's round
    against its roofline and its state's bytes against the meta count, (c)
    kernels_bench on the card with check_regression, (d) the analysis.
    The meta-device counts run as processes of their own, started first
    and awaited last; every one is stopped on the way out."""
    import os
    import tempfile

    from repro_torch.analysis import ast_rules, load_baseline, trace_audit
    from repro_torch.benchmarks import (check_regression, kernels_bench,
                                        roofline_report)
    from repro_torch.core import tree as T
    from repro_torch.kernels import ops
    from repro_torch.launch import inputs as I
    from repro_torch.launch import roofline as R
    from repro_torch.launch.mesh import make_card_mesh

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tools-"))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = []
    try:
        for arch, shape in TOOLS_DRYRUN:
            out = tmp / f"{arch}.{shape}.jsonl"
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--device", "meta",
                   "--out", str(out)]
            procs.append((f"dryrun {arch} {shape}", out, subprocess.Popen(
                cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        counter = subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"),
             "--pod-round-counts"], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        procs.append(("pod round counts", None, counter))
        t_start = time.perf_counter()

        # (c) kernels_bench on the card, held against the CPU run's file
        rows = kernels_bench.main([], device="cuda", out_json=str(
            out_dir / "BENCH_kernels_torch.json"))
        torch.cuda.synchronize()
        for r in rows:
            log(f"tools (c) {r}")
        code = check_regression.main([
            f"{out_dir / 'BENCH_kernels_torch.json'}:"
            f"{ROOT / 'BENCH_kernels_torch.json'}",
            "--require", "sparse_aggregate"])
        if code != 0:
            raise AssertionError("tools (c): check_regression failed")

        # (d) the analysis
        baseline = load_baseline(str(ROOT / "analysis_baseline_torch.json"))
        new, suppressed, stale = baseline.apply(ast_rules.run_ast_rules(
            str(ROOT)))
        log(f"tools (d) AST rules: {len(new)} new, {len(suppressed)} "
            f"suppressed, {len(stale)} stale")
        cover = trace_audit.audit_kernel_coverage(str(ROOT))
        log(f"tools (d) kernel coverage: {len(ops.KERNELS)} kernels, "
            f"{[f.format() for f in cover]}")
        seen = []
        retrace = trace_audit.audit_retrace(
            (("sync", {}), trace_audit.RETRACE_MATRIX[1], ("async", {})),
            include_pod=False, device="cuda", seen=seen)
        for ctxname, what, launches in seen:
            log(f"tools (d) per-round audit {ctxname} {what}: launches "
                f"{launches}")
        log(f"tools (d) per-round audit on the card: "
            f"{[f.format() for f in retrace]}")
        launched = {c for c, _, n in seen if n}
        if new or stale or cover or retrace or len(launched) != 3:
            raise AssertionError("tools (d): the analysis is not clean")

        # (a) the dry-run lines, then the report
        records = []
        for name, out, proc in procs:
            text, err = proc.communicate(timeout=max(
                1.0, TOOLS_TIMEOUT - (time.perf_counter() - t_start)))
            if proc.returncode != 0:
                raise AssertionError(f"tools: {name} exited "
                                     f"{proc.returncode}:\n{text}\n{err}")
            if out is None:
                counts = json.loads(text.strip().splitlines()[-1])
                continue
            records += [json.loads(x) for x in out.read_text().splitlines()]
        log(f"tools (a) the meta-device processes: "
            f"{time.perf_counter() - t_start:.1f}s")
        for r in records:
            log(f"tools (a) {r['arch']} {r['shape']}: {r['status']}, "
                f"counted {r['flops']:.6g} FLOP, model {r['model_flops']:.6g}"
                f", useful {r['useful_flop_frac']:.4f}, bytes "
                f"{r['bytes']:.6g}, compute {r['compute_s']:.6g}s, memory "
                f"{r['memory_s']:.6g}s, collective {r['collective_s']}s, "
                f"dominant {r['dominant']}, state "
                f"{r['per_device_hbm_gb']:.3f} GiB ({r['peaks']}; counted "
                f"in {r['t_compile_s']}s)")
            if r["status"] != "ok" or not r["flops"] > 0:
                raise AssertionError(f"tools (a): {r['arch']} {r['shape']}")
        path = tmp / "baseline_singlepod_torch.jsonl"
        path.write_text("".join(json.dumps(r) + "\n" for r in records))
        report = roofline_report.main([], results=[("singlepod",
                                                    str(path))])
        if len(report) != len(TOOLS_DRYRUN):
            raise AssertionError("tools (a): roofline_report's rows")

        # (b) phase 15's round against its roofline
        pod_roofline(R, smi, counts, pod_round)
        fed, run = pod_run_configs()
        state, _ = I.state_inputs(pod_config(), fed, run, make_card_mesh())
        meta_bytes = I.state_nbytes(state)
        sizes = [x.numel() * x.element_size() for k in ("params", "server")
                 for x in T.leaves(state[k])]
        slack = allocator_slack(sizes)
        diff = pod_round["state_alloc"] - meta_bytes
        log(f"tools (b) pod state: {pod_round['state_alloc']} bytes "
            f"allocated on the card (phase 15), {meta_bytes} counted on "
            f"meta in {len(sizes)} tensors: {diff:+d} bytes (allocator "
            f"rounding at most {slack}); the rounds' peak "
            f"{pod_round['peak'] / 2**30:.2f} GiB "
            f"(torch.cuda.max_memory_allocated)")
        if not 0 <= diff <= slack:
            raise AssertionError("tools (b): the state's bytes differ")
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import personalization_example, quickstart
    from repro_torch.configs.base import FedConfig
    from repro_torch.core import tree as T
    from repro_torch.data.partition import (dirichlet_partition,
                                            sort_and_partition)
    from repro_torch.data.synthetic import make_image_dataset
    from repro_torch.federated.simulator import FederatedSimulator, SimConfig
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import compress as CP
    from repro_torch.kernels import fedadc_update as FU
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import kd_loss as KD
    from repro_torch.kernels import sparse_reduce as SR
    from repro_torch.kernels import ssd_scan as SSD
    from repro_torch.kernels import weighted_reduce as WR
    from repro_torch.models.vision import cnn_init, resnet18_init

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t_start = time.perf_counter()

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    for rec in build.build_all():
        usage = ", ".join(f"{n} {r} registers" + (f" {sp} B spilled" if sp
                                                   else "")
                          for n, r, sp in ptxas_usage(rec["log"]))
        log(f"build: {Path(rec['source']).name} built={rec['built']} "
            f"in {rec['seconds']:.1f}s; {usage}")
    log(f"build: {time.perf_counter() - t0:.1f}s")

    # -- 2. kernels against plain, then timed ---------------------------------
    gen = torch.Generator().manual_seed(0)
    cnn_shapes = leaf_shapes(cnn_init(0, width=32, image_size=32,
                                      device="cpu"))
    resnet_leaf = [(512, 512, 3, 3)]
    resnet_shapes = leaf_shapes(resnet18_init(0, n_classes=100,
                                              device="cpu"))
    errs = {name: 0.0 for name in ops.KERNELS}

    def all_sweeps(shapes, dtype):
        return {**sweeps(torch, FU, WR, ref, shapes, dtype, gen),
                **wire_sweeps(torch, CP, SR, ref, shapes, dtype, gen)}
    for shapes in (cnn_shapes, resnet_leaf):
        for dtype in (torch.float32, torch.bfloat16):
            for name, (kern, plain, _) in all_sweeps(shapes, dtype).items():
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
    got = WR.weighted_reduce_leaves([d_bf16.cuda()],
                                    w96.cuda())[0].double().cpu()
    worst = ((got - oracle).abs() / oracle.abs()).max().item()
    log(f"check weighted_reduce bf16 K=96 vs fp64: max rel err {worst} "
        f"(bar 2**-8 = {2.0 ** -8})")
    if worst > 2.0 ** -8:
        raise AssertionError("weighted_reduce K=96 bf16 misses 1 bf16 ulp")
    del d64, d_bf16, oracle
    # the sparse reduce: K=96 bf16 top-k wires of the largest leaf against
    # an fp64 oracle, then duplicate indices within a client (pair order)
    n_big = 2359296
    k_big = topk_k(n_big)
    vals = (1.0 + 0.05 * torch.randn((96, k_big), generator=gen)).to(
        torch.bfloat16)
    idx = torch.stack([torch.randperm(n_big, generator=gen)[:k_big]
                       for _ in range(96)])
    w96 = torch.rand(96, generator=gen) * 0.8 + 0.2
    oracle = torch.zeros(n_big, dtype=torch.float64).index_add_(
        0, idx.reshape(-1), (w96.double()[:, None] * vals.double()).reshape(-1))
    got = SR.sparse_reduce(vals.cuda(), idx.to("cuda", torch.int32),
                           w96.cuda(), (n_big,), torch.float32).double().cpu()
    hit = oracle != 0
    worst = ((got - oracle).abs()[hit] / oracle.abs()[hit]).max().item()
    log(f"check sparse_reduce bf16 K=96 k={k_big} vs fp64: max rel err "
        f"{worst} (bar 2**-8), off-support sum {got[~hit].abs().sum().item()}")
    if worst > 2.0 ** -8 or got[~hit].any():
        raise AssertionError("sparse_reduce K=96 bf16 misses 1 bf16 ulp")
    dup_v = torch.randn((8, 4096), generator=gen).cuda()
    dup_i = torch.randint(0, 997, (8, 4096), generator=gen).to("cuda",
                                                              torch.int32)
    for dt in (torch.float32, torch.bfloat16):
        e = max_err([SR.sparse_reduce(dup_v.to(dt), dup_i, w96[:8].cuda(),
                                      (997,), dt)],
                    [ref.sparse_weighted_delta_reduce(
                        dup_v.to(dt), dup_i, w96[:8].cuda(), (997,), dt)])
        log(f"check sparse_reduce {dt} duplicate indices (4096 pairs into "
            f"997 elements per client): max |kernel - plain| = {e}")
        if e != 0.0:
            raise AssertionError("sparse_reduce differs from its plain "
                                 "version on duplicate indices")
    del vals, idx, oracle, got
    sweep_kernel_checks(torch, FU, WR, CP, SR, ref, gen, resnet_shapes,
                        errs)
    update_kernel_checks(torch, FU, ref, gen, resnet_shapes, errs)
    t0 = time.perf_counter()
    kd_kernel_checks(torch, KD, ref, gen, errs)
    log(f"kd checks: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    lm_kernel_checks(torch, FA, SSD, ref, gen, errs)
    log(f"lm checks: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    shapes_phase(torch, np, gen, errs)
    log(f"shapes: {time.perf_counter() - t0:.1f}s")

    cnn_sizes = [int(torch.Size(s).numel()) for s in cnn_shapes]
    timed = {}
    for name, (kern, plain, lib) in all_sweeps(cnn_shapes,
                                               torch.float32).items():
        b_ms, b_by = bound(name, cnn_sizes)
        lib_ms, yardsticks = time_library(torch, lib)
        timed[name] = {"ms": cuda_ms(torch, kern),
                       "plain_ms": cuda_ms(torch, plain),
                       "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"time {name} over the CNN's {len(cnn_sizes)} leaves (fp32"
            f"{', K=8' if name != 'server_update' else ''}): "
            f"{json.dumps(timed[name])}"
            + (f"; yardsticks {json.dumps(yardsticks)}" if yardsticks
               else ""))
        if name == "qsgd":
            log(f"time qsgd over the CNN's leaves, yardsticks: "
                f"{json.dumps(qsgd_yardsticks(torch, CP, cnn_shapes, gen))}")
        if name == "threshold_select":
            log(f"time threshold_select over the CNN's leaves, yardsticks: "
                f"{json.dumps(select_yardsticks(torch, CP, cnn_shapes, gen))}")
        if name == "server_update":
            log(f"time the local and server updates over the CNN's leaves, "
                f"yardsticks: "
                f"{json.dumps(update_yardsticks(torch, FU, cnn_shapes, gen))}")
        if name in SWEEP_KERNELS:
            lib_fn = next(iter(lib.values())) if isinstance(lib, dict) else lib
            log(f"time {name} over the CNN's leaves, device ms by kernel: "
                f"{json.dumps(device_ms_by_kernel(torch, kern))}; the "
                f"library's: {json.dumps(device_ms_by_kernel(torch, lib_fn))}")
    for name, (kern, plain, lib) in all_sweeps(resnet_leaf,
                                               torch.float32).items():
        b_ms, b_by = bound(name, [2359296])
        lib_ms, yardsticks = time_library(torch, lib)
        log(f"time {name} on ResNet-18's largest leaf (2359296): "
            f"ms={cuda_ms(torch, kern)} plain_ms={cuda_ms(torch, plain)} "
            f"library_ms={lib_ms} bound_ms={b_ms} ({b_by})"
            + (f"; yardsticks {json.dumps(yardsticks)}" if yardsticks
               else ""))
        if name in SWEEP_KERNELS:
            log(f"time {name} on ResNet-18's largest leaf, device ms by "
                f"kernel: {json.dumps(device_ms_by_kernel(torch, kern))}")
        if name == "qsgd":
            log(f"time qsgd on ResNet-18's largest leaf, yardsticks: "
                f"{json.dumps(qsgd_yardsticks(torch, CP, resnet_leaf, gen))}")
        if name == "server_update":
            log(f"time the local and server updates on ResNet-18's largest "
                f"leaf, yardsticks: "
                f"{json.dumps(update_yardsticks(torch, FU, resnet_leaf, gen))}")
    # the KD kernels at the FedADC+ CNN's folded (512, 10) (the line's
    # numbers), an LM vocabulary's (1024, 32768) in fp32 and bf16 and 8 rows
    # of it; no single PyTorch call computes this loss, so there is no
    # library time
    log(f"time kd_loss and kd_loss_bwd, yardsticks: "
        f"{json.dumps(kd_yardsticks(torch, KD, gen))}")
    for rows, n_classes, groups, dtype in (
            (*KD_SHAPES[0], torch.float32), (*KD_SHAPES[-1], torch.float32),
            (*KD_SHAPES[-1], torch.bfloat16), (8, 32768, 1, torch.float32)):
        s_, t_, y_, rho_, g_ = kd_operands(torch, rows, n_classes, groups,
                                           dtype, gen)
        stats_ = KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)[3]
        calls = {
            "kd_loss": (
                lambda: KD.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU),
                lambda: ref.kd_loss(s_, t_, y_, rho_, KD_LAM, KD_TAU)),
            "kd_loss_bwd": (
                lambda: KD.kd_loss_bwd(s_, t_, y_, rho_, stats_, g_, KD_LAM,
                                       KD_TAU),
                lambda: ref.kd_loss_bwd(s_, t_, y_, rho_, stats_, g_, KD_LAM,
                                        KD_TAU))}
        for name, (kern, plain) in calls.items():
            b_ms, b_by = kd_bound(name, rows, n_classes, groups,
                                  elem_bytes=s_.element_size())
            rec = {"ms": cuda_ms(torch, kern),
                   "plain_ms": cuda_ms(torch, plain), "library_ms": None,
                   "bound_ms": b_ms, "bound_by": b_by}
            log(f"time {name} ({rows}, {n_classes}) G={groups} {dtype}: "
                f"{json.dumps(rec)}")
            if (rows, n_classes, dtype) == (*KD_SHAPES[0][:2], torch.float32):
                timed[name] = rec
    del s_, t_, y_, rho_, g_, stats_
    timed.update(lm_kernel_times(torch, FA, SSD, ref, gen))

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
    groups = table_groups(n_leaves)
    expected = {"fused_axpy": 5 * 2 * H * groups + H * groups,
                "local_update": H * groups,
                "server_update": 5 * groups + groups,
                "weighted_reduce": 5 * groups + 2 * groups,
                "threshold_select": 0, "qsgd": 0, "sparse_reduce": 0,
                "kd_loss": 0, "kd_loss_bwd": 0, "flash_attention": 0,
                "ssd_scan": 0}
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
    update_kernels = ("fused_axpy", "local_update", "server_update",
                      "weighted_reduce")
    if launches != expected or min(launches[n] for n in update_kernels) == 0:
        raise AssertionError("main: kernel launches differ from the count "
                             "the rounds should make")

    # one profiled FedADC round: device time by kernel and the idle share
    main_round_s = round_s
    main_idle = profile_round(torch, sim, round_s, "profile")

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

    # -- 4. the compressed wire on the main path ------------------------------
    # the first round of each wire runs cuDNN's deterministic algorithms, so
    # (a) and (b) see bit-identical deltas and differ only by their wire;
    # the later rounds, which are timed, run the library defaults
    cudnn_det = torch.backends.cudnn.deterministic
    params_w0 = cnn_init(11, width=32, image_size=32, device="cpu")
    wire_launches = {n: 0 for n in ("threshold_select", "qsgd",
                                    "sparse_reduce")}
    first_update = {}
    R = 4
    for tag, wkw in WIRES.items():
        fed_w = FedConfig(eta=ETA, **wkw)
        sim_w = FederatedSimulator(
            fed_w, SimConfig(model="cnn", n_classes=10, rounds=R,
                             eval_every=R, cnn_width=32, seed=11),
            x, y, xt, yt, parts,
            params=T.tree_map(lambda t: t.clone(), params_w0))
        ops.reset_launch_counts()
        round_s, picks_all = [], []
        for r in range(R):
            torch.backends.cudnn.deterministic = cudnn_det if r else True
            inputs = sim_w.next_round_inputs()
            picks_all.append(inputs[0])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = sim_w.run_round(*inputs)
            torch.cuda.synchronize()
            round_s.append(time.perf_counter() - t0)
            if not torch.isfinite(loss):
                raise AssertionError(f"wire {tag}: non-finite loss {loss}")
            if len(round_s) == 1:
                first_update[tag] = [
                    (a.cpu() - b).double() for a, b in
                    zip(T.leaves(sim_w.params), T.leaves(params_w0))]
        counts = ops.launch_counts()
        want = expected_wire_launches(tag, R, n_leaves, H)
        log(f"wire {tag}: round seconds {round_s}, last loss {float(loss)}, "
            f"accuracy {sim_w.evaluate()}")
        log(f"wire {tag}: launches {counts}, expected {want}")
        if counts != want:
            raise AssertionError(f"wire {tag}: kernel launches differ from "
                                 f"the count the rounds should make")
        for name in wire_launches:
            wire_launches[name] += counts[name]
        tr = sim_w.transport
        up_want = R * K * tr.uplink_wire_nbytes(sim_w.params)
        down_want = expected_downlink_bytes(fed_w, tr, enumerate(picks_all))
        log(f"wire {tag}: uplink bytes {sim_w.uplink_bytes} (wire sizes "
            f"give {up_want}, raw {sim_w.uplink_bytes_raw}); downlink bytes "
            f"{sim_w.downlink_bytes} (wire sizes give {down_want}, raw "
            f"{sim_w.downlink_bytes_raw}); catch-ups {sim_w.refs.catchups}, "
            f"resyncs {sim_w.refs.resyncs}")
        if (sim_w.uplink_bytes, sim_w.downlink_bytes) != (up_want,
                                                          down_want):
            raise AssertionError(f"wire {tag}: measured bytes differ from "
                                 f"the wire sizes")
        profile_round(torch, sim_w, round_s, f"wire {tag} profile", top=8)
    # the first round's update under (a) and (b), from the same parameters
    # and batches: the reconstructions are equal except where magnitudes tie
    # at the threshold (the dense select keeps every tied entry, the sparse
    # wire exactly k: one τ-sized entry among a leaf's k ≥ 1 kept), and both
    # aggregates sum in fp32 in client order
    ua, ub = first_update["a_topk_dense"], first_update["b_topk_sparse"]
    err = math.sqrt(sum(((a - b) ** 2).sum().item() for a, b in zip(ua, ub))
                    / sum((a ** 2).sum().item() for a in ua))
    log(f"wire: (a) dense vs (b) sparse top-k, first round's update: "
        f"|dθ_a - dθ_b| / |dθ_a| = {err} (bar 1e-3)")
    if not err <= 1e-3:
        raise AssertionError("wire: dense and sparse top-k disagree")

    # -- 5. FedADC+ and the Table I baselines on the main path ----------------
    params_d0 = cnn_init(13, width=32, image_size=32, device="cpu")
    sim_d = FederatedSimulator(
        FedConfig(eta=ETA, distill=True, distill_lambda=KD_LAM,
                  distill_tau=KD_TAU),
        SimConfig(model="cnn", n_classes=10, rounds=R, eval_every=R,
                  cnn_width=32, seed=13),
        x, y, xt, yt, parts, params=T.tree_map(lambda t: t.clone(), params_d0))
    ops.reset_launch_counts()
    round_s = []
    for _ in range(R):
        inputs = sim_d.next_round_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = sim_d.run_round(*inputs)
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
        if not torch.isfinite(loss):
            raise AssertionError(f"distill: non-finite loss {loss}")
    distill_launches = ops.launch_counts()
    want = expected_wire_launches("plain", R, n_leaves, H)
    want.update(kd_loss=R * H, kd_loss_bwd=R * H)
    log(f"distill: FedADC+ round seconds {round_s}, last loss {float(loss)}, "
        f"accuracy {sim_d.evaluate()}")
    log(f"distill: launches {distill_launches}, expected {want}")
    if distill_launches != want:
        raise AssertionError("distill: kernel launches differ from the count "
                             "the rounds should make")
    idle = profile_round(torch, sim_d, round_s, "distill profile", top=10)

    def median_ms(seconds):
        later = sorted(seconds[1:])
        return later[len(later) // 2] * 1e3
    log(f"distill: FedADC+ median round {median_ms(round_s):.3f} ms, idle "
        f"share {idle}; plain FedADC (phase 3, same run) median round "
        f"{median_ms(main_round_s):.3f} ms, idle share {main_idle}")
    # the baselines at Table I's eta 0.05 (logged: from this init the
    # full-width CNN's local steps diverge at that rate, under the plain CE
    # of FedAvg as under every baseline), then at the main path's eta
    runs = ([(n, TABLE1_ETA) for n in BASELINES + ("fedavg",)]
            + [(n, ETA) for n in BASELINES])
    for strategy, eta in runs:
        sim_b = FederatedSimulator(
            FedConfig(strategy=strategy, eta=eta),
            SimConfig(model="cnn", n_classes=10, rounds=1, eval_every=1,
                      cnn_width=32, seed=13),
            x, y, xt, yt, parts,
            params=T.tree_map(lambda t: t.clone(), params_d0))
        inputs = sim_b.next_round_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = sim_b.run_round(*inputs)
        torch.cuda.synchronize()
        extra = ""
        if strategy == "moon":
            n_bytes = sum(t.numel() * t.element_size()
                          for st in sim_b.client_states.values()
                          for t in T.leaves(st))
            extra = (f"; {len(sim_b.client_states)} previous models kept, "
                     f"{n_bytes} bytes on the card")
        log(f"distill baseline {strategy} (eta {eta}): one round "
            f"{time.perf_counter() - t0:.3f}s, loss {float(loss)}{extra}")
        if eta == ETA and not torch.isfinite(loss):
            raise AssertionError(f"distill baseline {strategy}: non-finite "
                                 f"loss")
        del sim_b
    # the card (TF32 off) against the CPU on one one-step FedADC+ round from
    # the same parameters and batches, at phase 3's one-step bar
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    ends = []
    for device in ("cuda", "cpu"):
        sim_c = FederatedSimulator(
            FedConfig(eta=ETA, local_steps=1, distill=True,
                      distill_lambda=KD_LAM, distill_tau=KD_TAU),
            SimConfig(cnn_width=32, seed=7), x, y, xt, yt, parts,
            params=T.tree_map(lambda t: t.clone(), params0), device=device)
        sim_c.run_round(*sim_c.next_round_inputs())
        ends.append(T.tree_map(lambda t: t.cpu(), sim_c.params))
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    num = sum(((a - b) ** 2).sum()
              for a, b in zip(T.leaves(ends[0]), T.leaves(ends[1])))
    den = sum(((b - p) ** 2).sum()
              for b, p in zip(T.leaves(ends[1]), T.leaves(params0)))
    err = (num / den).sqrt().item()
    log(f"distill compare: one one-step FedADC+ round, |dθ card - dθ cpu| / "
        f"|dθ cpu| = {err} (bar 1e-4)")
    if not err <= 1e-4:
        raise AssertionError("card and CPU disagree on a FedADC+ round")

    # -- 6. ResNet-18 at CIFAR-100 shape ------------------------------------
    x100, y100, xt100, yt100 = make_image_dataset(50000, 10000, 100,
                                                  image_size=32)
    parts100 = dirichlet_partition(y100, n_clients=100, alpha=0.3)
    s = FederatedSimulator(FedConfig(local_steps=2, eta=ETA),
                           SimConfig(model="resnet18", n_classes=100,
                                     rounds=1, eval_every=1),
                           x100, y100, xt100, yt100, parts100)
    rshapes = leaf_shapes(s.params)
    rsizes = [int(torch.Size(sh).numel()) for sh in rshapes]
    log(f"resnet18: {len(rshapes)} leaves, {sum(rsizes)} parameters")
    ops.reset_launch_counts()
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
    counts = ops.launch_counts()
    want = expected_wire_launches("plain", 2, len(rshapes), 2)
    log(f"resnet18: launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("resnet18: kernel launches differ from the "
                             "count the rounds should make")
    log(f"resnet18: accuracy {s.evaluate()}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, (kern, plain, lib) in sweeps(torch, FU, WR, ref, rshapes,
                                           torch.float32, gen).items():
        b_ms, b_by = bound(name, rsizes)
        lib_ms, yardsticks = time_library(torch, lib, iters=10)
        log(f"time {name} over ResNet-18's {len(rshapes)} leaves: "
            f"ms={cuda_ms(torch, kern, iters=10)} "
            f"plain_ms={cuda_ms(torch, plain, iters=3, warmup=1)} "
            f"library_ms={lib_ms} bound_ms={b_ms} ({b_by})"
            + (f"; yardsticks {json.dumps(yardsticks)}" if yardsticks
               else ""))
    log(f"time the local and server updates over ResNet-18's "
        f"{len(rshapes)} leaves, yardsticks: "
        f"{json.dumps(update_yardsticks(torch, FU, rshapes, gen, iters=10))}")
    # the sparse reduce over all 76 leaves (one call, two table groups)
    # beside the per-leaf index_add_ sweep, the threshold select (one call,
    # two launches) beside torch.where; the plain versions are not timed
    wire_r = wire_sweeps(torch, CP, SR, ref, rshapes, torch.float32, gen)
    for name in ("sparse_reduce", "threshold_select"):
        kern, _, lib = wire_r[name]
        b_ms, b_by = bound(name, rsizes)
        lib_ms, yardsticks = time_library(torch, lib, iters=10)
        log(f"time {name} over ResNet-18's {len(rshapes)} leaves: "
            f"ms={cuda_ms(torch, kern, iters=10)} library_ms={lib_ms} "
            f"bound_ms={b_ms} ({b_by})"
            + (f"; yardsticks {json.dumps(yardsticks)}" if yardsticks
               else ""))
    log(f"time threshold_select over ResNet-18's {len(rshapes)} leaves, "
        f"yardsticks: "
        f"{json.dumps(select_yardsticks(torch, CP, rshapes, gen, iters=10))}")
    del wire_r

    # ResNet-18 on the sparse top-k wire and on QSGD with the delta+QSGD
    # downlink: one round each after a first one that pays for start-up
    for tag in ("b_topk_sparse", "c_qsgd_delta_qsgd"):
        s = FederatedSimulator(FedConfig(local_steps=2, eta=ETA,
                                         **WIRES[tag]),
                               SimConfig(model="resnet18", n_classes=100,
                                         rounds=1, eval_every=1),
                               x100, y100, xt100, yt100, parts100)
        ops.reset_launch_counts()
        for r in range(2):
            inputs = s.next_round_inputs()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = s.run_round(*inputs)
            torch.cuda.synchronize()
            log(f"resnet18 wire {tag}: round {r + 1} "
                f"{time.perf_counter() - t0:.3f}s, loss {float(loss)}")
            if not torch.isfinite(loss):
                raise AssertionError(f"resnet18 wire {tag}: non-finite loss")
        counts = ops.launch_counts()
        want = expected_wire_launches(tag, 2, len(rshapes), 2)
        log(f"resnet18 wire {tag}: launches {counts}, expected {want}; "
            f"uplink {s.uplink_bytes} of raw {s.uplink_bytes_raw} bytes")
        if counts != want:
            raise AssertionError(f"resnet18 wire {tag}: launches differ")
        del s
    # ResNet-18 under FedADC+: the KD kernels at C=100
    s = FederatedSimulator(FedConfig(local_steps=2, eta=ETA, distill=True),
                           SimConfig(model="resnet18", n_classes=100,
                                     rounds=1, eval_every=1),
                           x100, y100, xt100, yt100, parts100)
    ops.reset_launch_counts()
    for r in range(2):
        inputs = s.next_round_inputs()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = s.run_round(*inputs)
        torch.cuda.synchronize()
        log(f"resnet18 fedadc+: round {r + 1} "
            f"{time.perf_counter() - t0:.3f}s, loss {float(loss)}")
        if not torch.isfinite(loss):
            raise AssertionError("resnet18 fedadc+: non-finite loss")
    counts = ops.launch_counts()
    want = expected_wire_launches("plain", 2, len(rshapes), 2)
    want.update(kd_loss=2 * 2, kd_loss_bwd=2 * 2)
    log(f"resnet18 fedadc+: launches {counts}, expected {want}")
    if counts != want:
        raise AssertionError("resnet18 fedadc+: kernel launches differ")
    del s

    # -- 7. the port's quickstart -------------------------------------------
    t0 = time.perf_counter()
    hist = quickstart.run(device="cuda")
    gap = hist["fedadc"][-1]["acc"] - hist["fedavg"][-1]["acc"]
    log(f"quickstart: {time.perf_counter() - t0:.1f}s, "
        f"FedADC - FedAvg = {gap:+.3f}")

    # -- 8. the port's personalization example ------------------------------
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gains = personalization_example.run(device="cuda")
    counts = ops.launch_counts()
    # 20 FedADC+ rounds of H=8, then 60 calibration steps per client shown
    want_kd = 20 * 8 + 60 * len(gains)
    log(f"personalization: {time.perf_counter() - t0:.1f}s, mean gain "
        f"{sum(gains) / len(gains):+.3f}; kd_loss {counts['kd_loss']}, "
        f"kd_loss_bwd {counts['kd_loss_bwd']} launches (expected {want_kd})")
    if not (gains and all(math.isfinite(g) for g in gains)
            and counts["kd_loss"] == counts["kd_loss_bwd"] == want_kd):
        raise AssertionError("personalization: bad gains or KD launches")

    # -- 9. serving Zamba2-1.2B at full width -------------------------------
    t0 = time.perf_counter()
    serve_launches = serve_phase(torch, np)
    log(f"serve: {time.perf_counter() - t0:.1f}s")

    # -- 10. the semi-async engine on the main path ---------------------------
    t0 = time.perf_counter()
    async_phase(torch, (x, y, xt, yt, parts))
    log(f"async: {time.perf_counter() - t0:.1f}s")

    # -- 11. the fleet substrate on the main path -----------------------------
    t0 = time.perf_counter()
    fleet_phase(torch, (x, y, xt, yt, parts))
    log(f"fleet: {time.perf_counter() - t0:.1f}s")

    # -- 12. the paper's benchmark drivers -----------------------------------
    t0 = time.perf_counter()
    bench_phase(torch)
    log(f"bench: {time.perf_counter() - t0:.1f}s")

    # -- 13. telemetry on the three engines and its two drivers ---------------
    t0 = time.perf_counter()
    before = ops.launch_counts()
    telemetry_phase(torch, (x, y, xt, yt, parts))
    log(f"telemetry: launches over the phase {launch_diff(ops, before)}; "
        f"{time.perf_counter() - t0:.1f}s")

    # -- 14. the rest of the LM stack at full width ---------------------------
    t0 = time.perf_counter()
    arch_launches = archs_phase(torch, np)
    log(f"archs: {time.perf_counter() - t0:.1f}s")

    # -- 15. the pod engine -------------------------------------------------
    t0 = time.perf_counter()
    pod_launches, pod_kd, pod_round = pod_phase(torch, np)
    log(f"pod: {time.perf_counter() - t0:.1f}s")

    # -- 16. the launch tooling and the analysis ----------------------------
    t0 = time.perf_counter()
    tools_phase(torch, smi, pod_round)
    log(f"tools: {time.perf_counter() - t0:.1f}s")

    log(f"total: {time.perf_counter() - t_start:.1f}s")
    # launches: the update kernels' from the main path (phase 3), the wire
    # kernels' from the wire phase (4), the KD kernels' from FedADC+ (5),
    # flash attention's and the SSD scan's from the serve phase (9) and the
    # archs phase (14)
    launches.update(wire_launches)
    launches.update({n: distill_launches[n] for n in ("kd_loss",
                                                      "kd_loss_bwd")})
    launches.update({n: serve_launches[n] + arch_launches[n]
                     for n in serve_launches})
    # and the pod engine's (phase 15) on rows 1-6, 8 and 8b
    launches.update({n: launches[n] + pod_launches[n] for n in POD_KERNELS})
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE[name],
         "replaces": TPU_KERNEL[name], "launches": launches[name],
         "max_abs_err": errs[name], **timed[name]}
        for name in ops.KERNELS]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="On-card smoke run of the PyTorch port.")
    parser.add_argument("--kernel-times", action="store_true",
                        help="only build and time the SSD scan, QSGD, the "
                             "update and select sweeps and the KD forward "
                             "(kernel_times) and print them as one JSON line")
    parser.add_argument("--kernel-shapes", action="store_true",
                        help="only build and check and time the shapes that "
                             "the reference's kernels take beyond the port's "
                             "first limits (shapes_phase) and print the "
                             "times as one JSON line")
    parser.add_argument("--pod-round-counts", action="store_true",
                        help="only count phase 15's mixed round on the meta "
                             "device and print the counts as one JSON line")
    parser.add_argument("--src", default=str(ROOT / "src"),
                        help="with --kernel-times: the src/ directory whose "
                             "repro_torch to time")
    args = parser.parse_args()
    if args.pod_round_counts:
        sys.exit(pod_round_counts_main(args.src))
    if args.kernel_shapes:
        sys.exit(kernel_shapes_main())
    sys.exit(kernel_times_main(args.src) if args.kernel_times else main())
