"""Beyond-paper: the pod engine's FedADC vs FedAvg on federated LM
fine-tuning (domain-skewed Markov token streams, a cut-down qwen3-family
model), the counterpart of ``benchmarks/lm_round.py``: evidence that the
momentum embedding transfers from the paper's vision tasks to the LMs of
``configs/``.

Each strategy trains ``ROUNDS`` rounds of 4 clients x H 4 steps of b 2 x
L 64 tokens from seed 0, then reports its held-out loss over 64 documents
of every domain; the clock stops after the card has finished the rounds.
Rows: ``lm_round.<strategy>.heldout_loss`` (µs a round, the loss) and
``lm_round.fedadc_minus_fedavg``.
"""
import time
from dataclasses import replace

import numpy as np
import torch

from repro_torch.benchmarks.common import block_until_ready, emit
from repro_torch.configs import get_arch
from repro_torch.configs.base import FedConfig, RunConfig
from repro_torch.data.synthetic import make_token_dataset
from repro_torch.device import resolve_device
from repro_torch.launch.train import init_state, make_train_step
from repro_torch.models.registry import get_model

ROUNDS = 60


def model_config():
    """The benchmark's model: reduced qwen3-4b at 2 layers, d_model 256,
    vocab 1024."""
    base = get_arch("qwen3-4b").reduced()
    return replace(base, n_layers=2, d_model=256, d_ff=704, vocab_size=1024,
                   n_heads=4, n_kv_heads=2, head_dim=64)


def run(strategy, eta, seed=0, device=None):
    device = resolve_device(device)
    mcfg = model_config()
    fed = FedConfig(strategy=strategy, local_steps=4, clients_per_round=4,
                    eta=eta, beta_global=0.7, beta_local=0.7)
    run_cfg = RunConfig(remat="none")
    seq = 64
    tokens, domains = make_token_dataset(512, seq + 1, mcfg.vocab_size,
                                         seed=0)
    clients = [np.where(domains == d)[0] for d in range(8)]
    held = tokens[:64]

    state = init_state(seed, mcfg, fed, run_cfg, device=device)
    step = make_train_step(mcfg, fed, run_cfg)
    rng = np.random.RandomState(seed)
    b = 2
    block_until_ready(device)
    t0 = time.time()
    for r in range(ROUNDS):
        picks = rng.choice(len(clients), fed.clients_per_round, replace=False)
        bt = np.zeros((1, 4, 4, b, seq + 1), np.int32)
        for ci, c in enumerate(picks):
            sel = rng.choice(clients[c], (4, b))
            bt[0, ci] = tokens[sel]
        bt = torch.from_numpy(bt).to(device)
        state, m = step(state, {"tokens": bt[..., :-1],
                                "labels": bt[..., 1:]})
    # wait for the card and stop the clock before the evaluation, so the
    # timed window covers exactly the ROUNDS rounds
    block_until_ready(device)
    us_per_round = (time.time() - t0) / ROUNDS * 1e6
    # held-out loss over all domains
    held = torch.from_numpy(held).to(device)
    with torch.no_grad():
        loss = float(get_model(mcfg).loss_fn(
            state["params"], {"tokens": held[:, :-1],
                              "labels": held[:, 1:]}, mcfg)[0])
    return loss, us_per_round


def main(rows=None, device=None):
    rows = rows if rows is not None else []
    losses = {}
    for strat, eta in (("fedavg", 0.05), ("fedadc", 0.05)):
        loss, us = run(strat, eta, device=device)
        losses[strat] = loss
        rows.append(emit(f"lm_round.{strat}.heldout_loss", us, f"{loss:.4f}"))
    rows.append(emit("lm_round.fedadc_minus_fedavg", 0,
                     f"{losses['fedadc'] - losses['fedavg']:+.4f} "
                     f"(negative = FedADC better)"))
    return rows


if __name__ == "__main__":
    main()
