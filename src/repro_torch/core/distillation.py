"""Losses of the local objective (counterpart of the JAX package's
``core/distillation.py``).  This slice has the plain cross-entropy; the
self-confidence KD of FedADC+ and the FedGKD/FedNTD/FedRS/MOON losses come
with the next slice."""
from __future__ import annotations

import torch


def cross_entropy(logits, labels):
    """Mean over the batch of fp32 logsumexp minus the gold logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)
