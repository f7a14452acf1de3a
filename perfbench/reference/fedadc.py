"""Plain reference of FedADC rounds (the paper's Algorithm 3, the
nesterov variant, the plain wire), client by client.  A traffic mix names
the round reference it is judged by (``"reference": "fedadc"``); this
one covers what ``covers`` accepts and nothing else.

Per round t, from the server's θ_t and momentum m_t (stored in the master
dtype, the configuration's ``param_dtype``):

* broadcast: θ_t and m_t stored in the local dtype; m̄ = β_local·m_t/H,
  stored in the local dtype;
* each client, H local steps on its own batches, each step stored in the
  local dtype: θ^{½} = θ − η·m̄, g = ∇f(θ^{½}), θ = θ^{½} − η·g;
* Δ_i = θ_t − θ_i^H in float32, Δ̄ their mean (uniform weights);
* server, in float32, each result stored in the master dtype:
  m_{t+1} = Δ̄/η + (β_global − β_local)·m_t, θ_{t+1} = θ_t − α·η·m_{t+1}.

Every operation is float32 arithmetic; only the stored state (and, with
``compute``, the forward pass) takes the precision the configuration
states.  The loss is any ``loss(params, batch)`` over a flat parameter
dict.

Returned readings: each round's loss (the mean over its clients of their
steps' mean loss), the per-leaf norm of m after the first round (the
first gradient as the server's optimizer has it), and the per-leaf norm
of θ_n − θ_0 after the last round.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

from perfbench.tree import flatten, leaf_norms

# FedConfig fields whose value the rounds above assume (a field left out
# of a mix takes FedConfig's default, which these are)
ASSUMES = {"strategy": "fedadc", "variant": "nesterov",
           "aggregator": "uniform", "compressor": "none",
           "downlink_compressor": "none", "distill": False,
           "weight_decay": 0.0, "grad_clip": 0.0, "fleet_regions": 0,
           "buffer_k": 0, "sparse_uplink": False, "downlink_unicast": False}


def covers(fed: Dict) -> Optional[str]:
    """None where these rounds are the mix's strategy and wire, else what
    they do not follow."""
    off = [f"{k}={fed[k]!r}" for k, v in ASSUMES.items()
           if k in fed and fed[k] != v]
    return f"the FedADC reference does not follow {', '.join(off)}" \
        if off else None


def first_gradient(server: Dict, params: Dict, theta0: Callable,
                   fed: Dict) -> Dict[str, torch.Tensor]:
    """The program's first gradient as its server optimizer has it after
    one round, flat: the momentum m_1 (``server``: the program's server
    state; ``params``: its flat parameters; ``theta0()``: the first
    weights, flat)."""
    return flatten(server["m"])


def run(loss: Callable, params0: Dict[str, torch.Tensor],
        rounds: Iterable[List[List[dict]]], fed: Dict,
        dtypes: Dict[str, torch.dtype]) -> Dict:
    """``rounds``: per round, per client, per local step, the step's batch;
    ``dtypes``: ``master``, ``local`` and ``compute``
    -> {"loss": [...], "grad": {path: norm}, "change": {path: norm}}."""
    eta, alpha = fed["eta"], fed["alpha"]
    bl, bg, H = fed["beta_local"], fed["beta_global"], fed["local_steps"]
    local_dtype, compute_dtype = dtypes["local"], dtypes["compute"]

    def q(t):
        return t.to(local_dtype)

    def keep(t):
        return t.to(dtypes["master"])
    theta = {k: keep(v.float()) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in theta.items()}
    out = {"loss": []}
    for r, clients in enumerate(rounds):
        theta_t = {k: q(v) for k, v in theta.items()}
        m_bar = {k: q(q(v).float() * (bl / H)) for k, v in m.items()}
        acc = {k: torch.zeros_like(v) for k, v in theta.items()}
        client_losses = []
        for steps in clients:
            th = dict(theta_t)
            step_losses = []
            for batch in steps:
                half = {k: q(th[k].float() - eta * m_bar[k].float())
                        for k in th}
                leaves = {k: v.to(compute_dtype, copy=True)
                          .requires_grad_() for k, v in half.items()}
                with torch.enable_grad():
                    val = loss(leaves, batch)
                    grads = torch.autograd.grad(val, list(leaves.values()),
                                                allow_unused=True)
                step_losses.append(float(val.detach()))
                th = {k: q(half[k].float() - eta * (
                    0.0 if g is None else g.float()))
                    for (k, g) in zip(leaves, grads)}
                del leaves, grads, half
            for k in acc:
                acc[k].add_(theta_t[k].float() - th[k].float())
            client_losses.append(sum(step_losses) / len(step_losses))
            del th
        n = len(clients)
        for k in theta:
            d_bar = acc[k] / n
            m_new = d_bar / eta + (bg - bl) * m[k].float()
            theta[k] = keep(theta[k].float() - alpha * eta * m_new)
            m[k] = keep(m_new)
        del acc, theta_t, m_bar
        out["loss"].append(sum(client_losses) / n)
        if r == 0:
            out["grad"] = leaf_norms(m)
    out["change"] = leaf_norms({k: theta[k].float() - params0[k].float()
                                for k in theta})
    return out
