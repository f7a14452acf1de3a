"""The synchronous simulator (``repro_torch.federated.simulator``) as a
cell's system under test: ``FederatedSimulator.next_round_inputs()`` (the
data staging: picks, numpy gather, host-to-device copy) then
``run_round(...)`` once a round.

The configuration file gives the vision model, the clients' data (made
by the traffic generator from the seed: images, labels, a Dirichlet
partition) and the round's shape (|S| clients of H local steps on
batches of b); the mix gives the strategy and the wire.  Weights come
from the configuration's reference module (``make_params``, on the card
from the seed) through ``params=``.  The simulator draws its picks and
batches from ``np.random.RandomState`` seeded from the seed; the
reference draws them again with its own sampler.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from perfbench import manifest
from perfbench.reference.sampler import RoundSampler
from perfbench.traffic.generate import image_clients, np_seed
from perfbench.tree import flatten, leaf_norms, unflatten
from perfbench.yardstick.flops import conv_train_flops, resnet18_forward_macs
from perfbench.yardstick.kernel_bytes import plain_fedadc, sweep


class Engine:
    def __init__(self, cell: manifest.Cell, seed: int, device: str,
                 fault: Optional[str] = None):
        self.cell, self.seed, self.device, self.fault = cell, seed, device, \
            fault
        self.cfg = cell.config
        self.model = self.cfg["model"]
        self.ref = manifest.module(cell.bench, "reference",
                                   self.cfg["reference"])
        self.rounds_ref = manifest.round_reference(cell)
        self.shape = cell.round
        self.fed_kw = dict(cell.mix["fed"])
        self.sim_seed = np_seed(seed, 4)
        self.program = None

    def setup(self):
        t = time.perf_counter()
        from repro_torch.configs.base import FedConfig
        from repro_torch.federated.simulator import (FederatedSimulator,
                                                     SimConfig)
        self.times = {"imports": time.perf_counter() - t}
        s, d = self.shape, self.cfg["data"]
        t = time.perf_counter()
        self.x, self.y, self.parts = image_clients(d, self.seed)
        self.times["traffic"] = time.perf_counter() - t
        t = time.perf_counter()
        fed = FedConfig(local_steps=s["H"], clients_per_round=s["clients"],
                        n_clients=d["n_clients"], **self.fed_kw)
        sim = SimConfig(model=self.model["arch"],
                        n_classes=self.model["n_classes"],
                        batch_size=s["b"], seed=self.sim_seed)
        params = unflatten(self.ref.make_params(self.model, self.seed,
                                                self.device))
        self.program = {"sim": FederatedSimulator(
            fed, sim, self.x, self.y, self.x[:0], self.y[:0], self.parts,
            params=params, device=self.device), "loss": None}
        self.times["weights and program"] = time.perf_counter() - t

    def step(self, r: int, spans):
        sim = self.program["sim"]
        before = (sim.params, sim.server_state)
        if spans is None:
            picks, xb, yb = sim.next_round_inputs()
        else:
            with spans("stage"):
                picks, xb, yb = sim.next_round_inputs()
        if self.fault == "half":
            half = self.shape["b"] // 2
            xb, yb = xb[:, :, :half], yb[:, :, :half]
        if spans is None:
            loss = sim.run_round(picks, xb, yb)
        else:
            with spans("engine"):
                loss = sim.run_round(picks, xb, yb)
        if self.fault == "unchanged":
            sim.params, sim.server_state = before
        self.program["loss"] = loss

    def loss(self) -> float:
        v = float(self.program["loss"])
        return v * 1.05 if self.fault == "loss" else v

    def gradient_norms(self) -> Dict[str, float]:
        sim = self.program["sim"]
        return leaf_norms(self.rounds_ref.first_gradient(
            sim.server_state, flatten(sim.params),
            lambda: self.ref.make_params(self.model, self.seed, self.device),
            self.fed_kw))

    def change_norms(self) -> Dict[str, float]:
        theta0 = self.ref.make_params(self.model, self.seed, self.device)
        now = flatten(self.program["sim"].params)
        return {k: float(torch.linalg.vector_norm(now[k].float() - v))
                for k, v in theta0.items()}

    def free(self):
        self.program = None

    def reference(self, rounds: int, control: Optional[str] = None) -> Dict:
        s = self.shape
        sampler = RoundSampler(self.sim_seed, self.parts, s["clients"],
                               s["H"], s["b"])

        def clients():
            sel = sampler.next_round()           # (K, H, b) indices
            return [[{"images": torch.from_numpy(self.x[sel[c, h]]).to(
                self.device), "labels": torch.from_numpy(
                    self.y[sel[c, h]]).to(self.device)}
                for h in range(s["H"])] for c in range(sel.shape[0])]
        fed = {**self.fed_kw, "local_steps": s["H"]}
        params0 = self.ref.make_params(self.model, self.seed, self.device)
        return self.rounds_ref.run(
            lambda prm, bt: self.ref.loss(prm, bt, self.model),
            params0, (clients() for _ in range(rounds)), fed,
            self.cell.dtypes(control))

    def flops_per_round(self) -> float:
        s = self.shape
        macs = resnet18_forward_macs(self.cfg["data"]["image_size"],
                                     self.model["n_classes"])
        return conv_train_flops(macs, s["clients"] * s["H"] * s["b"])

    def sweeps(self) -> Optional[List[Dict]]:
        if not plain_fedadc(self.fed_kw):
            return None
        s, n, K = self.shape, self.cfg["params"], self.shape["clients"]
        return [sweep("fused_axpy", 2 * s["H"], elements=K * n, itemsize=4),
                sweep("weighted_reduce", 1, elements=n, rows=K, itemsize=4),
                sweep("server_update", 1, elements=n, theta_itemsize=4)]
