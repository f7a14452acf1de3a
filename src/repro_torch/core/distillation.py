"""Self-knowledge-distillation losses (Sec. III), the counterpart of the
JAX package's ``core/distillation.py``.

The paper's *self-confidence knowledge distillation* (FedADC+, eqs.
(6)-(9)) plus the baselines it generalises and the other loss modifiers of
Table I:

* FedGKD  — KL(student ‖ global teacher) over all classes.
* FedNTD  — KL over the NOT-TRUE classes only.
* FedRS   — restricted softmax: logits of absent classes scaled by α.
* MOON    — model-contrastive term on the features.
* self-confidence (FedADC+) — the teacher's probabilities reweighted per
  class by (1 − ρ_{i,k}), ρ_{i,k} = γ_{i,k}/γ_k^max how well class i is
  represented in client k's data; the true class absorbs the leftover mass
  (eqs. (8), (9)).  When data is iid ρ ≈ 1 and the loss degrades to CE.

The self-confidence loss goes through the KD kernel (``kernels.ops.kd_loss``:
the CUDA kernel and its backward kernel on the card, their plain versions on
the CPU); the rest is plain torch, as it is plain jnp in the reference.
All take logits, so they serve class logits and (masked) token logits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ref import one_hot


def softmax_T(logits, tau):
    return torch.softmax(logits.float() / tau, dim=-1)


def kl_loss(p_student_logits, target_probs, tau):
    """Eq. (6): L_KL(p, p̂) = −Σ p̂_i log(p_i/p̂_i).  Mean over batch."""
    logp = torch.log_softmax(p_student_logits.float() / tau, -1)
    t = torch.clamp(target_probs, 1e-9, 1.0)
    kl = torch.sum(t * (torch.log(t) - logp), dim=-1)
    return torch.mean(kl) * (tau ** 2)


def cross_entropy(logits, labels):
    """Mean over the batch of fp32 logsumexp minus the gold logit."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - gold)


def class_confidence(class_counts):
    """ρ_{i,k} = γ_{i,k} / γ_k^max (eq. before (8)).  counts (C,)."""
    counts = class_counts.float()
    gamma = counts / torch.clamp(counts.sum(), min=1.0)
    return gamma / torch.clamp(gamma.max(), min=1e-9)


def self_confidence_targets(teacher_logits, labels, rho, tau):
    """Eqs. (8), (9): p̂ from the (global-model) teacher prediction and the
    local confidence vector ρ (C,).  labels (B,) int."""
    p_t = softmax_T(teacher_logits, tau)                     # (B, C)
    onehot = one_hot(labels, p_t.shape[-1])
    damp = (1.0 - rho)[None, :] * p_t                        # (1-ρ_i)·p̃^(i)
    non_true = damp * (1.0 - onehot)                         # eq. (8)
    true_mass = 1.0 - non_true.sum(-1, keepdim=True)         # eq. (9)
    return non_true + onehot * true_mass


def _kd_rows(student_logits, teacher_logits, labels, class_counts, lam, tau):
    """The KD kernel's per-row (loss, ce, kl), the teacher detached (the
    reference's stop_gradient); both logits in one dtype."""
    return ops.kd_loss(student_logits, teacher_logits.detach(), labels,
                       class_confidence(class_counts), lam, tau)


def self_confidence_kd_loss(student_logits, teacher_logits, labels,
                            class_counts, lam, tau):
    """Eq. (7) with the self-confidence target — the FedADC+ objective:
    (1 − λ)·mean CE + λ·mean τ²·KL, as the mean of the kernel's rows."""
    loss, ce, kl = _kd_rows(student_logits, teacher_logits, labels,
                            class_counts, lam, tau)
    return torch.mean(loss), {"ce": torch.mean(ce), "kd": torch.mean(kl)}


def masked_self_confidence_kd_loss(student_logits, teacher_logits, labels,
                                   class_counts, lam, tau, mask):
    """Token-level FedADC+ objective with a validity mask.

    Padding positions (label −100, clipped to 0 upstream) contribute to
    neither the CE nor the KD term: both are averaged over valid positions
    only.  mask (N,) bool/0-1, aligned with the flattened logits."""
    loss, ce, kl = _kd_rows(student_logits, teacher_logits, labels,
                            class_counts, lam, tau)
    w = mask.float()
    denom = torch.clamp(w.sum(), min=1.0)
    return (torch.sum(loss * w) / denom,
            {"ce": torch.sum(ce * w) / denom, "kd": torch.sum(kl * w) / denom})


def fedgkd_loss(student_logits, teacher_logits, labels, lam, tau):
    ce = cross_entropy(student_logits, labels)
    kd = kl_loss(student_logits, softmax_T(teacher_logits.detach(), tau), tau)
    return ce + lam * kd, {"ce": ce, "kd": kd}


def fedntd_loss(student_logits, teacher_logits, labels, beta, tau):
    """KL over not-true classes only (teacher and student renormalised after
    masking the true class)."""
    C = student_logits.shape[-1]
    onehot = one_hot(labels, C)
    mask = 1.0 - onehot
    s = student_logits.float() / tau + torch.log(mask + 1e-30)
    t = teacher_logits.detach().float() / tau + torch.log(mask + 1e-30)
    p_t = torch.softmax(t, -1)
    logp_s = torch.log_softmax(s, -1)
    kl = torch.sum(torch.where(mask > 0, p_t * (torch.log(torch.clamp(
        p_t, min=1e-9)) - logp_s), torch.zeros_like(p_t)), -1)
    ce = cross_entropy(student_logits, labels)
    return ce + beta * torch.mean(kl) * tau ** 2, {"ce": ce,
                                                    "kd": torch.mean(kl)}


def fedrs_logits(logits, class_present, alpha):
    """FedRS restricted softmax: scale logits of classes ABSENT from the
    client's data by α before CE.  class_present (C,) in {0,1}."""
    scale = class_present + (1.0 - class_present) * alpha
    return logits * scale[None, :]


def moon_loss(z, z_glob, z_prev, mu, temperature):
    """MOON model-contrastive term: positive = global-model features,
    negative = previous-local-model features."""
    def _cos(a, b):
        a = a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                            min=1e-9)
        b = b / torch.clamp(torch.linalg.vector_norm(b, dim=-1, keepdim=True),
                            min=1e-9)
        return torch.sum(a * b, -1)
    pos = _cos(z, z_glob) / temperature
    neg = _cos(z, z_prev) / temperature
    return mu * torch.mean(-pos + torch.logsumexp(
        torch.stack([pos, neg], -1), dim=-1))
