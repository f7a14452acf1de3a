"""The dry-run (counterpart of the JAX package's ``launch/dryrun.py``):
one step of an (arch × shape × mesh) run on the ``meta`` device under the
FLOP and byte counters of ``launch/roofline.py``, into the reference's
result dict with an H100 roofline.  Nothing is computed or allocated.

Run:  PYTHONPATH=src python -m repro_torch.launch.dryrun --device meta
          [--arch zamba2-1.2b] [--shape train_4k] [--multi-pod]
          [--out dryrun_results_torch.jsonl]

The reference lowers and compiles each step with XLA for a 512-device
placeholder mesh; here "lowering" is running the step once:

* train   — one FedADC round of the pod engine (``launch/train.py``), the
  plain route (the LM kernels refuse a gradient; on ``meta`` every kernel
  wrapper takes its plain version).  The round's loops (CS clients of H
  local steps) repeat the same work, so its counts are
  ``a + c·CS + s·CS·H``: a the broadcast, aggregate and server step, c a
  client's own work (its delta, its weighted add), s a local step (forward,
  backward, the update).  ``count_train_round`` runs the round at (CS, H)
  = (1, 1), (1, 2) and (2, 1) and composes the round from those three,
  exactly (``count_train_round(..., compose=False)`` runs the whole round,
  which the tests hold equal).
* prefill — the serving prefill step (full forward, last logits).
* decode  — one serve step against a cache of the shape's length.

``t_lower_s`` is the seconds to build the inputs and the step,
``t_compile_s`` those of the counted passes.  The multi-pod mesh (2, 16,
16) is counted against, never run: its round's R clients are counted as
one pod's (CP = 1, the card's; the per-pod recombine of CP rows is left
out), the counts split evenly over the 512 devices, and each device's
memory is the state's bytes over its specs' shard factors
(``sharding/specs.py``).  The default mesh is the card's (1, 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback

import torch

from repro_torch.configs import (ARCHS, SHAPES, get_arch, long_context_variant)
from repro_torch.configs.base import FedConfig, RunConfig
from repro_torch.launch import inputs as I
from repro_torch.launch import roofline as R
from repro_torch.launch.mesh import make_card_mesh, make_production_mesh


def _fed_for(shape, arch_id):
    """Round decomposition per shape: clients × H × b = global_batch."""
    return FedConfig(strategy="fedadc", clients_per_round=4, local_steps=4,
                     eta=0.05, beta_global=0.8, beta_local=0.8)


def _run_for(arch_id):
    # bf16 params for the huge archs; fp32 otherwise
    big = {"mistral-large-123b", "deepseek-v3-671b", "llama4-scout-17b-a16e",
           "internvl2-26b", "qwen1.5-32b"}
    return RunConfig(param_dtype="bfloat16" if arch_id in big else "float32",
                     remat="full")


def _clients(batch, cs, h):
    """The first cs clients and h steps of a (CP, CS, H, ...) batch."""
    return {k: (v[:, :cs] if k == "client_ids" else v[:, :cs, :h])
            for k, v in batch.items()}


def count_train_round(mcfg, fed, run, batch, compose=True) -> R.Counts:
    """One round of the pod engine on ``meta`` ``batch`` (leading (CP, CS,
    H), ``inputs.train_inputs``'s) under the counters (module
    docstring)."""
    from repro_torch.launch.train import make_train_step, state_shapes
    state = state_shapes(mcfg, fed, run)
    step = make_train_step(mcfg, fed, run)
    CS, H = batch["tokens"].shape[1:3]
    if not compose or CS * H <= 3:
        return R.count(step, state, batch)[1]
    f11 = R.count(step, state, _clients(batch, 1, 1))[1]
    f12 = R.count(step, state, _clients(batch, 1, 2))[1]
    f21 = R.count(step, state, _clients(batch, 2, 1))[1]
    s = f12.combine(f11, 1, -1)
    c = f21.combine(f12, 1, -1)
    a = f11.combine(c, 1, -1).combine(s, 1, -1)
    return a.combine(c, 1, CS).combine(s, 1, CS * H)


def _mesh(multi_pod):
    return make_production_mesh(multi_pod=True) if multi_pod \
        else make_card_mesh()


def lower_one(arch_id: str, shape_name: str, multi_pod: bool = False,
              fed=None, run=None, verbose: bool = True,
              serve_sharding: str = "serve", mcfg=None, peaks=None):
    """Count one (arch × shape × mesh) step on ``meta`` -> the reference's
    result dict with the roofline terms.  ``mcfg`` overrides the arch's
    config (a reduced one in tests); ``peaks`` the card's
    (``roofline.card_peaks()`` by default)."""
    shape = SHAPES[shape_name]
    mcfg = get_arch(arch_id) if mcfg is None else mcfg
    if shape_name == "long_500k":
        mcfg = long_context_variant(mcfg)
        if mcfg is None:
            return {"arch": arch_id, "shape": shape_name,
                    "multi_pod": multi_pod, "status": "skipped",
                    "reason": "no sub-quadratic decode path (DESIGN.md)"}
    fed = fed or _fed_for(shape, arch_id)
    run = run or _run_for(arch_id)
    mesh = _mesh(multi_pod)
    peaks = R.card_peaks() if peaks is None else peaks
    t0 = time.perf_counter()
    if shape.kind == "train":
        state, specs = I.state_inputs(mcfg, fed, run, mesh)
        batch, _ = I.train_inputs(mcfg, shape, fed, mesh, False)
        if multi_pod:
            # the R clients of the CP pods, counted as the card's one pod
            batch = {k: v.reshape((1, -1) + tuple(v.shape[2:]))
                     for k, v in batch.items()}
        hbm = I.state_nbytes(state, specs, mesh)
        t_lower = time.perf_counter() - t0
        counts = count_train_round(mcfg, fed, run, batch)
    elif shape.kind == "prefill":
        from repro_torch.launch.serve import make_prefill_step
        if serve_sharding == "serve":
            mcfg = dataclasses.replace(mcfg, moe_dispatch_axis="data")
        state, specs = I.state_inputs(mcfg, fed, run, mesh,
                                      mode=serve_sharding)
        batch, _ = I.prefill_inputs(mcfg, shape, mesh, multi_pod)
        hbm = I.sharded_bytes(state["params"], specs["params"], mesh)
        step = make_prefill_step(mcfg)
        t_lower = time.perf_counter() - t0
        with torch.no_grad():
            counts = R.count(step, state["params"], batch)[1]
    else:  # decode
        from repro_torch.launch.serve import make_serve_step
        # the >30B archs keep the FSDP layout (TP-only replicates dense
        # params over "data" past a device's memory)
        mode = serve_sharding
        if serve_sharding == "serve" and mcfg.param_count() > 30e9:
            mode = "train"
        if mode == "serve":
            mcfg = dataclasses.replace(mcfg, moe_dispatch_axis="data")
        state, specs = I.state_inputs(mcfg, fed, run, mesh, mode=mode)
        (cache, tokens, cur_pos, active), (cache_specs, *_) = \
            I.decode_inputs(mcfg, shape, mesh, multi_pod)
        hbm = I.sharded_bytes(state["params"], specs["params"], mesh) \
            + I.sharded_bytes(cache, cache_specs, mesh)
        if mcfg.is_encoder_decoder:
            # the batch-shared position is read on the host (``int``): a
            # Python int here, whose value no shape depends on
            cur_pos = shape.seq_len - 1
        step = make_serve_step(mcfg)
        t_lower = time.perf_counter() - t0
        with torch.no_grad():
            counts = R.count(step, state["params"], cache, tokens, cur_pos,
                             active)[1]
    t_compile = time.perf_counter() - t0 - t_lower
    mf = R.model_flops_per_round(mcfg, shape, fed)
    rl = R.analyze(counts, mesh, model_flops_per_chip=mf / mesh.size,
                   per_device_hbm=hbm, peaks=peaks)
    if verbose:
        print(f"== {arch_id} × {shape_name} × "
              f"{'multi' if multi_pod else 'single'}-pod (mesh "
              f"{dict(mesh.shape)}) ==")
        print({"state_bytes_per_device": hbm, "flops": counts.flops,
               "bytes accessed": counts.bytes})
    return {
        "arch": arch_id, "shape": shape_name, "multi_pod": multi_pod,
        "status": "ok", "t_lower_s": round(t_lower, 1),
        "t_compile_s": round(t_compile, 1),
        "model_flops": mf,
        "model_flops_per_chip": mf / rl.chips,
        "useful_flop_frac": (mf / rl.chips) / rl.flops if rl.flops else 0,
        "mesh": list(mesh.sizes),
        **rl.as_dict(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Count one step per (arch × shape × mesh) on the meta "
                    "device, with the card's roofline.")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results_torch.jsonl")
    ap.add_argument("--serve-sharding", default="serve",
                    choices=["train", "serve"])
    ap.add_argument("--device", default="meta", choices=["meta"],
                    help="the dry-run's tensors lie on meta: nothing is "
                         "computed or allocated")
    args = ap.parse_args(argv)

    archs = list(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    peaks = R.card_peaks()
    failed = False
    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    try:
                        res = lower_one(arch, shape, mp,
                                        serve_sharding=args.serve_sharding,
                                        peaks=peaks)
                    except Exception as e:
                        traceback.print_exc()
                        failed = True
                        res = {"arch": arch, "shape": shape, "multi_pod": mp,
                               "status": "error", "error": repr(e)[:500]}
                    print(json.dumps({k: v for k, v in res.items()
                                      if k not in ("flops", "bytes")},
                                     default=str)[:600], flush=True)
                    f.write(json.dumps(res, default=str) + "\n")
                    f.flush()
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
