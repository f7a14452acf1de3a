"""Learning-rate schedules (counterpart of the JAX package's
``optim/schedules.py``): functions of the round or step ``t`` giving an
fp32 scalar tensor, computed in fp32 as the reference computes them."""
from __future__ import annotations

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr):
    return lambda t: _f32(lr)


def cosine_decay(lr, total, floor=0.0):
    def f(t):
        frac = torch.clamp(_f32(t) / max(total, 1), 0.0, 1.0)
        return floor + (lr - floor) * 0.5 * (1 + torch.cos(_f32(math.pi)
                                                           * frac))
    return f


def warmup_cosine(lr, warmup, total, floor=0.0):
    cos = cosine_decay(lr, max(total - warmup, 1), floor)

    def f(t):
        w = torch.clamp(_f32(t) / max(warmup, 1), 0.0, 1.0)
        return torch.where(_f32(t) < warmup, lr * w, cos(_f32(t) - warmup))
    return f
