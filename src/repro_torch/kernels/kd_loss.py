"""The self-confidence KD loss of FedADC+ on the card (CUDA C++ in
``csrc/kd_kernels.cu``), forward and backward.

``kd_loss`` is the counterpart of the Pallas ``kd_loss`` in the JAX
package's ``kernels/kd_loss.py``: per row, (1 − λ)·CE + λ·τ²·KL(target ‖
softmax(s/τ)) with the self-confidence target of eqs. (8)-(9), one launch
for all rows.  Besides the loss it writes each row's CE, its KL and five
statistics (``ref.KD_STATS``) that ``kd_loss_bwd`` turns into ∂/∂s in one
pass; the reference has no backward, since it never trains through its
kernel.

``ρ`` is (G, C) with rows/G consecutive rows to each group.  The simulator
takes every client's gradient at once under ``torch.func.vmap``, and a
ctypes kernel cannot read a batched tensor's storage.  So both Functions
below carry a ``vmap`` rule that folds the vmapped client axis into the
row axis — K clients of b rows become K·b rows, their ρ K groups — and
launches once for all clients.

Each kernel wrapper checks its operands and raises on what the kernel does
not take, allocates its outputs with ``torch.empty``, launches on the
current stream, raises if the launch reports an error, and counts its
launches in a plain integer attribute.  The Functions take the plain
versions (``ref.kd_loss``, ``ref.kd_loss_bwd``) for CPU tensors and the
kernels for CUDA tensors, and nothing else picks the path.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

N_STATS = len(ref.KD_STATS)


def _check(name, s, t, labels, rho):
    """Check the operands both kernels share -> (rows, C, rows per group)."""
    check_operands(name, s, t)
    if s.dim() != 2 or s.shape[1] == 0:
        raise ValueError(f"{name}: logits must be (B, C) with C > 0, got "
                         f"{tuple(s.shape)}")
    rows, n_classes = s.shape
    dev = s.get_device()
    if not (labels.is_cuda and labels.get_device() == dev
            and labels.dtype == torch.int64 and labels.shape == (rows,)
            and labels.is_contiguous()):
        raise ValueError(f"{name}: labels must be contiguous int64 ({rows},) "
                         f"on cuda:{dev}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")
    if rho.dim() != 2 or rho.shape[1] != n_classes or rho.shape[0] == 0:
        raise ValueError(f"{name}: rho must be (G, {n_classes}), got "
                         f"{tuple(rho.shape)}")
    check_operands(name, rho, dtype=torch.float32, shape=rho.shape,
                   device=dev)
    if rows % rho.shape[0]:
        raise ValueError(f"{name}: {rows} rows do not split into "
                         f"{rho.shape[0]} groups")
    return rows, n_classes, max(rows // rho.shape[0], 1)


def kd_loss(s: torch.Tensor, t: torch.Tensor, labels: torch.Tensor,
            rho: torch.Tensor, lam: float, tau: float):
    """Student and teacher logits (B, C) fp32 or bf16 (one dtype), labels
    (B,) int64 in [0, C), ρ (G, C) fp32 -> (loss, ce, kl, stats): (B,) fp32
    each, stats (B, 5) fp32."""
    rows, n_classes, rpg = _check("kd_loss", s, t, labels, rho)
    loss, ce, kl = (torch.empty(rows, dtype=torch.float32, device=s.device)
                    for _ in range(3))
    stats = torch.empty((rows, N_STATS), dtype=torch.float32, device=s.device)
    if rows:
        build.launch("fedadc_kd_loss_fwd", s.data_ptr(), t.data_ptr(),
                     labels.data_ptr(), rho.data_ptr(), loss.data_ptr(),
                     ce.data_ptr(), kl.data_ptr(), stats.data_ptr(), rows,
                     n_classes, rpg, lam, tau, DTYPE_CODE[s.dtype], stream())
        kd_loss.launches += 1
    return loss, ce, kl, stats


def kd_loss_bwd(s: torch.Tensor, t: torch.Tensor, labels: torch.Tensor,
                rho: torch.Tensor, stats: torch.Tensor, g: torch.Tensor,
                lam: float, tau: float) -> torch.Tensor:
    """∂(Σ_i g_i·loss_i)/∂s from the forward's ``stats`` (B, 5) and the
    rows' upstream gradient g (B,) fp32 -> (B, C) in the logits' dtype."""
    rows, n_classes, rpg = _check("kd_loss_bwd", s, t, labels, rho)
    check_operands("kd_loss_bwd", stats, dtype=torch.float32,
                   shape=(rows, N_STATS), device=s.get_device())
    check_operands("kd_loss_bwd", g, dtype=torch.float32, shape=(rows,),
                   device=s.get_device())
    ds = torch.empty_like(s)
    if rows:
        build.launch("fedadc_kd_loss_bwd", s.data_ptr(), t.data_ptr(),
                     labels.data_ptr(), rho.data_ptr(), stats.data_ptr(),
                     g.data_ptr(), ds.data_ptr(), rows, n_classes, rpg, lam,
                     tau, DTYPE_CODE[s.dtype], stream())
        kd_loss_bwd.launches += 1
    return ds


kd_loss.launches = 0
kd_loss_bwd.launches = 0


def _fold(batch_size, in_dims, tensors):
    """The vmap rules' fold: bring each vmapped dim to the front, expand an
    unbatched tensor to the batch, and merge the batch axis into the first
    (row or group) axis: (K, b, ...) -> (K·b, ...)."""
    out = []
    for x, d in zip(tensors, in_dims):
        x = x.movedim(d, 0) if d is not None \
            else x.expand((batch_size,) + x.shape)
        out.append(x.flatten(0, 1))
    return out


class KDLoss(torch.autograd.Function):
    """(s, t, labels, ρ (G, C), λ, τ) -> (loss, ce, kl, stats) per row.
    Differentiable in s through ``loss`` only; ce, kl and the statistics are
    diagnostics, and the target is a constant (nothing flows to t or ρ)."""

    @staticmethod
    def forward(s, t, labels, rho, lam, tau):
        if s.device.type == "cpu":
            return ref.kd_loss(s, t, labels, rho, lam, tau)
        return kd_loss(s.contiguous(), t.contiguous(),
                       labels.long().contiguous(), rho.float().contiguous(),
                       lam, tau)

    @staticmethod
    def setup_context(ctx, inputs, output):
        s, t, labels, rho, lam, tau = inputs
        ctx.save_for_backward(s, t, labels, rho, output[3])
        ctx.lam, ctx.tau = lam, tau
        ctx.mark_non_differentiable(*output[1:])

    @staticmethod
    def backward(ctx, g, _ce, _kl, _stats):
        s, t, labels, rho, stats = ctx.saved_tensors
        ds = KDLossBackward.apply(s, t, labels, rho, stats, g, ctx.lam,
                                  ctx.tau)
        return ds, None, None, None, None, None

    @staticmethod
    def vmap(info, in_dims, s, t, labels, rho, lam, tau):
        k = info.batch_size
        s, t, labels, rho = _fold(k, in_dims[:4], (s, t, labels, rho))
        out = KDLoss.apply(s, t, labels, rho, lam, tau)
        return tuple(o.unflatten(0, (k, -1)) for o in out), (0, 0, 0, 0)


class KDLossBackward(torch.autograd.Function):
    """The backward kernel as a Function of its own, so that the backward
    of ``KDLoss`` is itself vmappable (it has no backward of its own)."""

    @staticmethod
    def forward(s, t, labels, rho, stats, g, lam, tau):
        if s.device.type == "cpu":
            return ref.kd_loss_bwd(s, t, labels, rho, stats, g, lam, tau)
        return kd_loss_bwd(s.contiguous(), t.contiguous(),
                           labels.long().contiguous(),
                           rho.float().contiguous(), stats.contiguous(),
                           g.float().contiguous(), lam, tau)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("the KD loss has no second derivative")

    @staticmethod
    def vmap(info, in_dims, s, t, labels, rho, stats, g, lam, tau):
        k = info.batch_size
        folded = _fold(k, in_dims[:6], (s, t, labels, rho, stats, g))
        ds = KDLossBackward.apply(*folded, lam, tau)
        return ds.unflatten(0, (k, -1)), 0
