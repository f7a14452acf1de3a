"""The pod engine (``repro_torch.launch.train``) as a cell's system under
test: ``make_train_step(mcfg, fed, run)``'s step called as
``step(state, batch)`` once a round.

The configuration file gives the model (the port's ``ModelConfig``
fields), the round's shape (CP pods × CS clients × H local steps of b
sequences of L tokens) and the precision (``RunConfig``); the mix gives
the strategy and the wire (``FedConfig`` fields), the plain round
reference it is judged by, and any further round inputs the step reads
(``inputs``, such as ``client_ids``, made by the traffic generator).  Weights come from the
configuration's reference module (``make_params``, on the card from the
seed) and reach the port through ``init_state(..., params=...)``; the
tokens from the traffic generator, staged on the card once, each round
taking the next CP·CS·H·b documents (wrapping around), labels the tokens.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from perfbench import manifest
from perfbench.traffic.generate import round_input, token_docs
from perfbench.tree import flatten, leaf_norms, unflatten
from perfbench.yardstick.flops import lm_train_flops
from perfbench.yardstick.kernel_bytes import plain_fedadc, sweep


def model_config(cfg: Dict, pattern: List[str] = ()):
    """The port's ``ModelConfig`` from the configuration's ``model``: each
    key a field of it, a nested group the field's own config class (``ssm``,
    ``moe``, ``mla``), a list a tuple; ``pattern`` (the reference's block
    list) where the group names no ``block_pattern``."""
    import dataclasses
    import typing
    from repro_torch.configs import base
    hints = typing.get_type_hints(base.ModelConfig)
    kw = {}
    for k, v in cfg["model"].items():
        if isinstance(v, dict):
            cls = next(a for a in typing.get_args(hints[k])
                       if dataclasses.is_dataclass(a))
            v = cls(**v)
        elif isinstance(v, list):
            v = tuple(v)
        kw[k] = v
    if pattern:
        kw.setdefault("block_pattern", tuple(pattern))
    return base.ModelConfig(arch_id=cfg["name"], source=cfg["source"], **kw)


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
        self.program = None

    # ---- the program ------------------------------------------------------
    def setup(self):
        t = time.perf_counter()
        from repro_torch.configs.base import FedConfig, RunConfig
        from repro_torch.launch import train as PT
        self.times = {"imports": time.perf_counter() - t}
        s, p = self.shape, self.cfg["precision"]
        self.fed = FedConfig(local_steps=s["H"], clients_per_round=s["CS"],
                             **self.fed_kw)
        self.run = RunConfig(remat=p["remat"], param_dtype=p["param_dtype"],
                             compute_dtype=p["compute_dtype"])
        pattern = getattr(self.ref, "pattern", None)
        mcfg = model_config(self.cfg, pattern(self.model) if pattern else ())
        t = time.perf_counter()
        tokens = token_docs(self.cfg["data"], s["L"], self.model["vocab_size"],
                            self.seed)
        self.docs = torch.from_numpy(tokens).to(self.device)
        self.times["traffic"] = time.perf_counter() - t
        t = time.perf_counter()
        params = unflatten(self.ref.make_params(self.model, self.seed,
                                                self.device))
        state = PT.init_state(self.seed, mcfg, self.fed, self.run,
                              device=self.device, params=params)
        del params
        self.times["weights"] = time.perf_counter() - t
        t = time.perf_counter()
        step = PT.make_train_step(mcfg, self.fed, self.run)
        self.times["program"] = time.perf_counter() - t
        self.program = {"state": state, "step": step, "aux": None}

    def batch(self, r: int) -> Dict[str, torch.Tensor]:
        s = self.shape
        n = s["CP"] * s["CS"] * s["H"] * s["b"]
        idx = (torch.arange(n, device=self.device) + r * n) \
            % self.docs.shape[0]
        tok = self.docs[idx].reshape(s["CP"], s["CS"], s["H"], s["b"], -1)
        out = {"tokens": tok, "labels": tok}
        for name, spec in self.cell.mix.get("inputs", {}).items():
            out[name] = torch.as_tensor(round_input(
                name, spec, (s["CP"], s["CS"]), self.seed, r),
                device=self.device)
        return out

    def step(self, r: int, spans):
        b = self.batch(r)
        if self.fault == "half":
            # half of each step's sequences, or of its one sequence's tokens
            if self.shape["b"] > 1:
                cut = (Ellipsis, slice(self.shape["b"] // 2), slice(None))
            else:
                cut = (Ellipsis, slice(self.shape["L"] // 2))
            b = {k: v[cut] if v.dim() == 5 else v for k, v in b.items()}
        pr = self.program
        if spans is None:
            new, aux = pr["step"](pr["state"], b)
        else:
            with spans("engine"):
                new, aux = pr["step"](pr["state"], b)
        if self.fault != "unchanged":
            pr["state"] = new
        pr["aux"] = aux

    def loss(self) -> float:
        v = float(self.program["aux"]["loss"])
        return v * 1.05 if self.fault == "loss" else v

    def gradient_norms(self) -> Dict[str, float]:
        st = self.program["state"]
        return leaf_norms(self.rounds_ref.first_gradient(
            st["server"], flatten(st["params"]),
            lambda: self.ref.make_params(self.model, self.seed, self.device),
            self.fed_kw))

    def change_norms(self) -> Dict[str, float]:
        theta0 = self.ref.make_params(self.model, self.seed, self.device)
        now = flatten(self.program["state"]["params"])
        out = {k: float(torch.linalg.vector_norm(now[k].float() - v))
               for k, v in theta0.items()}
        del theta0
        return out

    def free(self):
        self.program = None

    # ---- the plain reference --------------------------------------------
    def reference(self, rounds: int, control: Optional[str] = None) -> Dict:
        params0 = self.ref.make_params(self.model, self.seed, self.device)
        s = self.shape

        def clients(r):
            b = self.batch(r)
            extra = [k for k in b if k not in ("tokens", "labels")]
            return [[{"tokens": b["tokens"][cp, c, h],
                      "labels": b["labels"][cp, c, h],
                      **{k: b[k][cp, c] for k in extra}}
                     for h in range(s["H"])]
                    for cp in range(s["CP"]) for c in range(s["CS"])]
        fed = {**self.fed_kw, "local_steps": s["H"]}
        return self.rounds_ref.run(
            lambda prm, bt: self.ref.loss(prm, bt, self.model),
            params0, (clients(r) for r in range(rounds)), fed,
            self.cell.dtypes(control))

    # ---- yardsticks --------------------------------------------------------
    def flops_per_round(self) -> float:
        s = self.shape
        tokens = s["CP"] * s["CS"] * s["H"] * s["b"] * s["L"]
        return lm_train_flops(self.cfg["params"], tokens,
                              bool(self.fed_kw.get("distill", False)))

    def sweeps(self) -> Optional[List[Dict]]:
        """The port's sweep kernels of a round, with the bytes each sweep
        needs; None where the strategy or the wire is not one whose sweeps
        are listed here."""
        if not plain_fedadc(self.fed_kw):
            return None
        s, n = self.shape, self.cfg["params"]
        local = 2 if self.cfg["precision"]["local_dtype"] == "bfloat16" \
            else 4
        return [sweep("fused_axpy", 2 * s["H"] * s["CS"] * s["CP"],
                      elements=n, itemsize=local),
                sweep("weighted_reduce", 1, elements=n, rows=s["CP"],
                      itemsize=4),
                sweep("server_update", 1, elements=n, theta_itemsize=4)]
