"""Federated fine-tuning of a (reduced) architecture of ``configs/``
through the pod engine, with a checkpoint at the end: the port's
counterpart of ``examples/pod_finetune.py``, with the same model, data,
configs and printout.

FedADC (nesterov) over 8 clients that each hold one domain of synthetic
Markov token streams (``make_token_dataset``), 4 clients a round x H 4
local steps; the CPU-sized model has ~8M parameters, ``--full`` ~100M.

Run:  PYTHONPATH=src python -m repro_torch.pod_finetune [--arch qwen3-4b]
          [--rounds 150] [--ckpt-dir DIR] [--full] [--device cpu]

It runs on the GPU unless ``--device cpu`` is given.  The checkpoint of
the final parameters goes to ``--ckpt-dir`` (default: ``fedadc_ckpt`` in
the temporary directory).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.checkpointing import save_checkpoint
from repro_torch.configs import get_arch
from repro_torch.configs.base import FedConfig, RunConfig
from repro_torch.core import tree as T
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import init_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--rounds", type=int, default=150)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "fedadc_ckpt"))
    ap.add_argument("--full", action="store_true",
                    help="~100M-param variant (slow on the CPU)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = get_arch(args.arch).reduced()
    if args.full:   # ~100M params
        mcfg = replace(base, n_layers=4, d_model=512, d_ff=1408,
                       vocab_size=2048, n_heads=8, n_kv_heads=4, head_dim=64)
    else:           # CPU-friendly demo (~8M params)
        mcfg = replace(base, n_layers=2, d_model=256, d_ff=704,
                       vocab_size=1024, n_heads=4, n_kv_heads=2, head_dim=64)
    fed = FedConfig(strategy="fedadc", variant="nesterov", local_steps=4,
                    clients_per_round=4, eta=0.02, beta_global=0.7,
                    beta_local=0.7)
    run = RunConfig(remat="none")

    seq, n_docs = 128 if args.full else 64, 512
    tokens, domains = make_token_dataset(n_docs, seq + 1, mcfg.vocab_size,
                                         seed=0)
    # non-iid: each client holds one domain's documents
    clients = [np.where(domains == d % 10)[0] for d in range(8)]

    state = init_state(0, mcfg, fed, run, device=device)
    step = make_train_step(mcfg, fed, run)
    n_params = sum(x.numel() for x in T.leaves(state["params"]))
    print(f"{args.arch}-reduced: {n_params/1e6:.1f}M params, "
          f"{fed.clients_per_round} clients × H={fed.local_steps}")

    rng = np.random.RandomState(0)
    b = 4 if args.full else 2
    t0 = time.time()
    for r in range(args.rounds):
        picks = rng.choice(len(clients), fed.clients_per_round, replace=False)
        batch_tok = np.zeros((1, fed.clients_per_round, fed.local_steps, b,
                              seq + 1), np.int32)
        for ci, c in enumerate(picks):
            sel = rng.choice(clients[c], (fed.local_steps, b))
            batch_tok[0, ci] = tokens[sel]
        batch_tok = torch.from_numpy(batch_tok).to(device)
        state, metrics = step(state, {"tokens": batch_tok[..., :-1],
                                      "labels": batch_tok[..., 1:]})
        if (r + 1) % 25 == 0:
            print(f"round {r+1:4d}  loss {float(metrics['loss']):.4f}  "
                  f"({(time.time()-t0)/(r+1):.2f}s/round)")
    path = save_checkpoint(args.ckpt_dir, args.rounds, state["params"])
    print(f"saved {path}")
    return state


if __name__ == "__main__":
    main()
