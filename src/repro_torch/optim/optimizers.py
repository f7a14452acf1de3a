"""Minimal optimizers over parameter trees (counterpart of the JAX
package's ``optim/optimizers.py``), with its signatures.

The FL strategies own the server update; these serve local steps that
want plain momentum SGD and the centralised baselines.  Each returns new
trees and leaves its inputs as they were.
"""
from __future__ import annotations

import torch

from repro_torch.core import tree as T


def sgd_update(params, grads, lr, weight_decay=0.0):
    if weight_decay > 0:
        grads = T.axpy(weight_decay, params, grads)
    return T.tree_map(lambda p, g: p - lr * g, params, grads)


def momentum_init(params):
    return T.zeros_like(params)


def momentum_update(params, grads, state, lr, beta=0.9, weight_decay=0.0,
                    nesterov=False):
    """-> (params', m' = beta·m + g); nesterov steps along beta·m' + g."""
    if weight_decay > 0:
        grads = T.axpy(weight_decay, params, grads)
    m = T.axpy(beta, state, grads)
    upd = T.axpy(beta, m, grads) if nesterov else m
    return T.tree_map(lambda p, u: p - lr * u, params, upd), m


def adamw_init(params):
    """First and second moments at zero and the step counter ``t`` (int32,
    on the parameters' device)."""
    device = T.leaves(params)[0].device
    return {"m": T.zeros_like(params), "v": T.zeros_like(params),
            "t": torch.zeros((), dtype=torch.int32, device=device)}


def adamw_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.0):
    """Bias-corrected Adam with decoupled weight decay -> (params',
    state')."""
    t = state["t"] + 1
    m = T.tree_map(lambda mi, g: b1 * mi + (1 - b1) * g, state["m"], grads)
    v = T.tree_map(lambda vi, g: b2 * vi + (1 - b2) * g * g, state["v"],
                   grads)
    bc1 = 1 - b1 ** t.float()
    bc2 = 1 - b2 ** t.float()

    def upd(p, mi, vi):
        return p - lr * ((mi / bc1) / (torch.sqrt(vi / bc2) + eps)
                         + weight_decay * p)
    return T.tree_map(upd, params, m, v), {"m": m, "v": v, "t": t}
