"""Personalization via classifier calibration (Sec. IV-D), the counterpart
of the JAX package's ``core/personalization.py``.

After federated training, each client fine-tunes ONLY the classifier head
on its local data (body frozen), optionally regularised by a proximal term
(FedProx-style) or by the self-confidence KD loss of Sec. III, which runs
through the KD kernels on the card.  This is the computation- and
communication-free personalization route the paper advocates, and it is
repeatable whenever local statistics change.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core import distillation as D
from repro_torch.core import tree as T


def _device(params):
    return T.leaves(params)[0].device


def calibrate_head(params: Dict, apply_fn: Callable, head_key: str,
                   x, y, counts, *, steps: int, batch_size: int, eta: float,
                   reg: str = "none", mu: float = 0.01, lam: float = 0.35,
                   tau: float = 1.0, seed: int = 0):
    """-> personalised params (only params[head_key] differs).

    ``x``, ``y`` the client's numpy data, ``counts`` its class counts (C,).
    reg: none | prox | kd   (kd = self-confidence distillation against the
    global model's own predictions, using the local class statistics).
    Batches are drawn from ``np.random.RandomState(seed)`` in the
    reference's order."""
    if reg not in ("none", "prox", "kd"):
        raise ValueError(f"unknown reg {reg!r}; known none, prox, kd")
    dev = _device(params)
    head0 = params[head_key]
    counts = torch.as_tensor(counts, dtype=torch.float32, device=dev)

    def loss(head, xb, yb, t_logits):
        logits = apply_fn(dict(params, **{head_key: head}), xb)
        if reg == "kd":
            return D.self_confidence_kd_loss(logits, t_logits, yb, counts,
                                             lam, tau)[0]
        out = D.cross_entropy(logits, yb)
        if reg == "prox":
            out = out + 0.5 * mu * T.sq_norm(T.sub(head, head0))
        return out

    grad = torch.func.grad(loss)
    rng = np.random.RandomState(seed)
    head = head0
    n = len(x)
    for _ in range(steps):
        sel = rng.randint(0, n, size=min(batch_size, n))
        xb = torch.from_numpy(np.asarray(x[sel])).to(dev)
        yb = torch.from_numpy(np.asarray(y[sel])).to(dev).long()
        t_logits = None
        if reg == "kd":
            with torch.no_grad():
                t_logits = apply_fn(params, xb)
        g = grad(head, xb, yb, t_logits)
        head = T.tree_map(lambda h, gi: h - eta * gi, head, g)
    return dict(params, **{head_key: head})


def personalized_accuracy(params, apply_fn, head_key, client_train,
                          client_test, counts, **kw):
    """Calibrate per client and report mean local test accuracy."""
    dev = _device(params)
    accs = []
    for (xtr, ytr), cts, (xte, yte) in zip(client_train, counts, client_test):
        if len(xte) == 0 or len(xtr) == 0:
            continue
        p = calibrate_head(params, apply_fn, head_key, xtr, ytr, cts, **kw)
        with torch.no_grad():
            logits = apply_fn(p, torch.as_tensor(np.asarray(xte), device=dev))
        labels = torch.as_tensor(np.asarray(yte), device=dev)
        accs.append(torch.mean((torch.argmax(logits, -1) == labels).float()))
    # device scalars accumulate; one host fetch at the end
    return float(np.mean(torch.stack(accs).cpu().numpy())) if accs else 0.0
