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
launches once for all clients; the backward's rule takes the rows that
the forward's folded.

The forward reads each row of s and t from device memory once: a warp a
row with the row in registers up to ``WARP_MAX_C`` classes, above that a
thread-block cluster a row with the row staged in shared memory
(``cluster_plan``), up to ``max_classes``.  Above that a row is split over
CTAs that no cluster ties (``fwd_plan``'s split route, three kernels: the
slices' log-sum-exps, their non-true sums, the rows), which read it twice.
Any C takes one of the three.  The backward is one elementwise
pass over tiles of the flattened logits (``bwd_plan``): a row's chunk of
``BWD_TILE`` classes, or whole rows where C is at most that.

Each kernel wrapper checks its operands and raises on what the kernel does
not take, allocates its outputs with ``torch.empty`` (the forward's four in
one buffer), launches on the current stream, raises if the launch reports
an error, and counts its launches in a plain integer attribute.  The
Functions take the plain versions (``ref.kd_loss``, ``ref.kd_loss_bwd``)
for CPU tensors and the kernels for CUDA tensors, and nothing else picks
the path.
"""
from __future__ import annotations

import torch
from torch._C._functorch import is_functorch_wrapped_tensor

from repro_torch.kernels import build, ref
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

N_STATS = len(ref.KD_STATS)
WARP_MAX_C = 1024        # kWarpRowMaxC in csrc/kd_kernels.cu: registers
SLICE_BYTES = 65536      # kSliceBytes: s and t of a cluster CTA's slice
MAX_CLUSTER = 8          # kMaxCluster
MAX_DYN_SMEM = 232448 - 1024   # kMaxDynSmem
BWD_TILE = 1024          # kBwdTile: elements of a backward tile at most
BWD_MAX_ROWS = 256       # kBwdMaxRows: whole rows of a backward tile
SPLIT_SLICE = 32 * 256   # kSplitSlice: classes a CTA of the split route


def cluster_plan(n_classes: int, esize: int):
    """The cluster route's shape for C > WARP_MAX_C classes of ``esize``
    bytes, as ``cluster_plan`` in the .cu computes it -> (CTAs a row,
    classes a CTA, dynamic shared memory bytes a CTA)."""
    cl = 1
    while cl < MAX_CLUSTER and -(-n_classes // cl) * 2 * esize > SLICE_BYTES:
        cl *= 2
    slice_ = (-(-n_classes // cl) + 7) // 8 * 8
    return cl, slice_, 2 * (slice_ * esize + 16)


def max_classes(esize: int) -> int:
    """The largest C the forward takes for logits of ``esize`` bytes: eight
    CTAs whose slices fill the shared memory a block can have."""
    slice_ = ((MAX_DYN_SMEM // 2 - 16) // esize) // 8 * 8
    return MAX_CLUSTER * slice_


def fwd_plan(rows: int, n_classes: int, esize: int):
    """The forward's route for (rows, C) logits of ``esize`` bytes, as
    ``launch_fwd`` in the .cu picks it -> (route, CTAs a row, classes a
    CTA, scratch floats): "warp" (C <= WARP_MAX_C, eight rows a CTA),
    "cluster" (C <= max_classes, ``cluster_plan``'s CTAs), else "split":
    cdiv(C, SPLIT_SLICE) CTAs a row and rows·(9·parts + 6) floats of
    partials.  Each route is one launch of the wrapper."""
    if n_classes <= WARP_MAX_C:
        return "warp", 1, n_classes, 0
    if n_classes <= max_classes(esize):
        cl, slice_, _ = cluster_plan(n_classes, esize)
        return "cluster", cl, slice_, 0
    parts = -(-n_classes // SPLIT_SLICE)
    return "split", parts, SPLIT_SLICE, rows * (9 * parts + 6)


def bwd_plan(rows: int, n_classes: int):
    """The backward's tiles, as ``launch_bwd`` in the .cu plans them ->
    (tiles, per_tile, wide): for C > BWD_TILE (wide) per_tile chunks of
    BWD_TILE classes a row, tile b the chunk b % per_tile of row b //
    per_tile; else per_tile whole rows a tile, tile b rows [b·per_tile,
    (b + 1)·per_tile)."""
    if n_classes > BWD_TILE:
        per = -(-n_classes // BWD_TILE)
        return rows * per, per, True
    per = min(BWD_TILE // n_classes, BWD_MAX_ROWS)
    return -(-rows // per), per, False


def _fits(s, t, labels, rho):
    """Whether the operands both kernels share are what they take: one
    test of all of them."""
    return (s.is_cuda and s.dtype in DTYPE_CODE and s.dim() == 2
            and s.shape[1] > 0 and t.dtype is s.dtype and t.shape == s.shape
            and t.device == s.device and s.is_contiguous()
            and t.is_contiguous() and labels.device == s.device
            and labels.dtype is torch.int64 and labels.shape == s.shape[:1]
            and labels.is_contiguous() and rho.device == s.device
            and rho.dtype is torch.float32 and rho.dim() == 2
            and rho.shape[1] == s.shape[1] and rho.shape[0] > 0
            and rho.is_contiguous() and s.shape[0] % rho.shape[0] == 0)


def _check(name, s, t, labels, rho):
    """Check the operands both kernels share -> (rows, C, rows per group).
    Only a failure of ``_fits`` re-derives which operand is at fault."""
    if _fits(s, t, labels, rho):
        return s.shape[0], s.shape[1], max(s.shape[0] // rho.shape[0], 1)
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
    each, stats (B, 5) fp32, all views of one buffer."""
    rows, n_classes, rpg = _check("kd_loss", s, t, labels, rho)
    route, ctas, _, n_scratch = fwd_plan(rows, n_classes, s.element_size())
    if route == "split" and rows * ctas >= 2 ** 31:
        raise ValueError(f"kd_loss: {rows} rows of {n_classes} classes "
                         f"need 2**31 CTAs or more")
    out = torch.empty((3 + N_STATS) * rows + n_scratch, dtype=torch.float32,
                      device=s.device)
    loss, ce, kl = out[:rows], out[rows:2 * rows], out[2 * rows:3 * rows]
    stats = out[3 * rows:(3 + N_STATS) * rows].view(rows, N_STATS)
    if rows:
        build.launch("fedadc_kd_loss_fwd", s.data_ptr(), t.data_ptr(),
                     labels.data_ptr(), rho.data_ptr(), loss.data_ptr(),
                     ce.data_ptr(), kl.data_ptr(), stats.data_ptr(),
                     out[(3 + N_STATS) * rows:].data_ptr() if n_scratch
                     else None, rows,
                     n_classes, rpg, lam, tau, DTYPE_CODE[s.dtype], stream())
        kd_loss.launches += 1
    return loss, ce, kl, stats


def kd_loss_bwd(s: torch.Tensor, t: torch.Tensor, labels: torch.Tensor,
                rho: torch.Tensor, stats: torch.Tensor, g: torch.Tensor,
                lam: float, tau: float) -> torch.Tensor:
    """∂(Σ_i g_i·loss_i)/∂s from the forward's ``stats`` (B, 5) and the
    rows' upstream gradient g (B,) fp32 -> (B, C) in the logits' dtype,
    each element rounded as ``ref.kd_loss_bwd`` rounds it on the card."""
    if not (_fits(s, t, labels, rho) and stats.device == s.device
            and stats.dtype is torch.float32
            and stats.shape == (s.shape[0], N_STATS)
            and stats.is_contiguous() and g.device == s.device
            and g.dtype is torch.float32 and g.shape == labels.shape
            and g.is_contiguous()):
        rows = _check("kd_loss_bwd", s, t, labels, rho)[0]
        check_operands("kd_loss_bwd", stats, dtype=torch.float32,
                       shape=(rows, N_STATS), device=s.get_device())
        check_operands("kd_loss_bwd", g, dtype=torch.float32, shape=(rows,),
                       device=s.get_device())
    rows, n_classes = s.shape
    ds = torch.empty_like(s)
    if rows:
        build.launch("fedadc_kd_loss_bwd", s.data_ptr(), t.data_ptr(),
                     labels.data_ptr(), rho.data_ptr(), stats.data_ptr(),
                     g.data_ptr(), ds.data_ptr(), rows, n_classes,
                     rows // rho.shape[0], 1 - lam, lam * tau, 1 / tau,
                     BWD_TILE, DTYPE_CODE[s.dtype], stream())
        kd_loss_bwd.launches += 1
    return ds


kd_loss.launches = 0
kd_loss_bwd.launches = 0


def _contig(x, dtype=None):
    """x in ``dtype`` (if given) and contiguous, untouched where it is."""
    if dtype is not None and x.dtype is not dtype:
        x = x.to(dtype)
    return x if x.is_contiguous() else x.contiguous()


def _fold(batch_size, in_dims, tensors):
    """The vmap rules' fold: bring each vmapped dim to the front, expand an
    unbatched tensor to the batch, and merge the batch axis into the first
    (row or group) axis: (K, b, ...) -> (K·b, ...), a view where the
    operand allows (batched at dim 0 and contiguous).  An unbatched ρ of
    one group stays one group: it serves every row of every client."""
    out = []
    for i, (x, d) in enumerate(zip(tensors, in_dims)):
        if d is None and i == 3 and x.shape[0] == 1:
            out.append(x)
            continue
        if d is None:
            x = x.expand((batch_size,) + x.shape)
        elif d:
            x = x.movedim(d, 0)
        out.append(x.flatten(0, 1))
    return out


def _unrecorded(*tensors):
    """Whether a vmap rule may run its Function's forward itself: no
    operand is wrapped by a transform below this vmap level and the logits
    need no autograd record.  That skips a second pass through torch.func's
    custom-Function dispatch, the larger part of a rule's host time."""
    return not (any(map(is_functorch_wrapped_tensor, tensors))
                or (tensors[0].requires_grad and torch.is_grad_enabled()))


def _operands(s, t, labels, rho):
    """The four operands both kernels share as they take them: contiguous,
    labels int64, ρ fp32 (each untouched where it is so)."""
    return (_contig(s), _contig(t), _contig(labels, torch.int64),
            _contig(rho, torch.float32))


class KDLoss(torch.autograd.Function):
    """(s, t, labels, ρ (G, C), λ, τ) -> (loss, ce, kl, stats) per row.
    Differentiable in s through ``loss`` only; ce, kl and the statistics are
    diagnostics, and the target is a constant (nothing flows to t or ρ)."""

    @staticmethod
    def forward(s, t, labels, rho, lam, tau):
        if ref.plain(s):
            return ref.kd_loss(s, t, labels, rho, lam, tau)
        return kd_loss(*_operands(s, t, labels, rho), lam, tau)

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
        # Under vmap(grad(...)) the context that the backward reads is the
        # grad level's: it holds the operands unfolded, so the backward's
        # rule would fold them again.  That rule gets this rule's ``stats``
        # back as the same object, so the folded operands ride on it.
        k = info.batch_size
        rows = _operands(*_fold(k, in_dims[:4], (s, t, labels, rho)))
        out = (KDLoss.forward if _unrecorded(*rows)
               else KDLoss.apply)(*rows, lam, tau)
        out_k = tuple(o.unflatten(0, (k, -1)) for o in out)
        out_k[3]._kd_rows = (*rows, out[3])
        return out_k, (0, 0, 0, 0)


class KDLossBackward(torch.autograd.Function):
    """The backward kernel as a Function of its own, so that the backward
    of ``KDLoss`` is itself vmappable (it has no backward of its own)."""

    @staticmethod
    def forward(s, t, labels, rho, stats, g, lam, tau):
        if ref.plain(s):
            return ref.kd_loss_bwd(s, t, labels, rho, stats, g, lam, tau)
        return kd_loss_bwd(*_operands(s, t, labels, rho), _contig(stats),
                           _contig(g, torch.float32), lam, tau)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, grad):
        raise NotImplementedError("the KD loss has no second derivative")

    @staticmethod
    def vmap(info, in_dims, s, t, labels, rho, stats, g, lam, tau):
        k = info.batch_size
        rows = getattr(stats, "_kd_rows", None)   # KDLoss.vmap's stats
        if rows is not None and in_dims[4] == 0:
            rows = (*rows, *_fold(k, in_dims[5:6], (g,)))
        else:
            rows = _fold(k, in_dims[:6], (s, t, labels, rho, stats, g))
        # the result has no backward, so only a wrapped operand needs apply
        ds = (KDLossBackward.apply if any(map(is_functorch_wrapped_tensor,
                                              rows))
              else KDLossBackward.forward)(*rows, lam, tau)
        return ds.unflatten(0, (k, -1)), 0
