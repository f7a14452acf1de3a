"""Fused FedADC update kernels on the card (CUDA C++ in
``csrc/fedadc_kernels.cu``).

Counterparts of the Pallas kernels in the JAX package's
``kernels/fedadc_update.py``: ``fused_axpy_leaves`` (``fused_axpy_2d``),
``local_update`` (``local_update_2d``) and ``server_update``
(``server_update_2d``).  Each takes contiguous CUDA tensors of any shape —
one leaf, or one leaf stacked over the round's clients — and treats them as
flat buffers; the TPU's (rows, 128) lane tiling has no counterpart here.
``fused_axpy_leaves`` takes a whole sweep, every leaf of a tree, as one
leaf table (``leaf_table.py``): one launch for up to 64 leaves.

Every wrapper checks its operands and raises on what the kernel does not
take, allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and counts its device
launches in a plain integer attribute (``fused_axpy_leaves.launches``: one
a sweep of up to 64 leaves) so a run can show that it went through the
kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, leaf_table

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(name: str, *tensors, dtype=None, shape=None,
                   device=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor with the given
    shape, dtype and device index (by default those of the first), in a
    dtype the kernel takes."""
    first = tensors[0]
    shape = first.shape if shape is None else shape
    dtype = first.dtype if dtype is None else dtype
    device = first.get_device() if device is None else device
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: needs CUDA tensors, got {t.device}")
        if t.get_device() != device:
            raise ValueError(f"{name}: operands on cuda:{device} and "
                             f"{t.device}")
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} where "
                             f"{dtype} {tuple(shape)} is needed")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def stream() -> int:
    """The current CUDA stream's handle, for a launch: read directly, since
    ``torch.cuda.current_stream()`` builds a Stream object each call, a
    host cost every launch pays."""
    return torch._C._cuda_getCurrentRawStream(torch._C._cuda_getDevice())


AXPY_TILE = 2048      # elements a block: kAxpyTile in csrc/fedadc_kernels.cu


def _sweep_plan(shapes, dtype, tile):
    """What an elementwise sweep writing leaves of ``shapes`` in blocks of
    ``tile`` elements (the axpy, the weighted reduce) needs besides the
    pointers, computed once per tree: the table rows with each output's
    byte offset in the output buffer, the buffer's length, each view's
    (shape, strides, offset) and the launches the table takes."""
    esize = torch.empty((), dtype=dtype).element_size()
    fields, units, views, off = [], [], [], 0
    for shape in shapes:
        n = math.prod(shape)
        fields.append((0, 0, off * esize, n))
        units.append((leaf_table.cdiv(n, tile),))
        views.append((shape, leaf_table.strides(shape), off))
        off += leaf_table.padded(n)
    rows, totals = leaf_table.pack(fields, units)
    return (rows, off, views,
            sum(1 for t in totals if t[0]))


def fused_axpy_leaves(xs, ys, a: float):
    """x_i + a·y_i for every pair of leaves, in one launch a group of 64
    leaves -> the outputs, in order, as views of one buffer.  The leaves
    may differ in shape but share one dtype and device.  The host work is
    one lean pass over the leaves; the rest is planned once per tree."""
    if len(xs) != len(ys):
        raise ValueError(f"fused_axpy: {len(xs)} x leaves, {len(ys)} y")
    if not xs:
        return []
    dtype, dev = xs[0].dtype, xs[0].get_device()
    if dtype not in DTYPE_CODE:
        raise ValueError(f"fused_axpy: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    for x, y in zip(xs, ys):
        if (x.get_device() != dev or y.get_device() != dev or dev < 0
                or x.dtype is not dtype or y.dtype is not dtype
                or not x.is_contiguous() or not y.is_contiguous()):
            check_operands("fused_axpy", x, y, dtype=dtype, shape=x.shape,
                           device=dev)
            raise ValueError(f"fused_axpy: operands on cuda:{dev} and "
                             f"{x.device}, {y.device}")
    shapes = tuple(x.shape for x in xs)
    if tuple(y.shape for y in ys) != shapes:
        raise ValueError("fused_axpy: x and y leaves differ in shape")
    rows, out, views, launches = sweep_table(shapes, dtype, xs[0].device,
                                             AXPY_TILE)
    rows[:, 0] = [x.data_ptr() for x in xs]
    rows[:, 1] = [y.data_ptr() for y in ys]
    build.launch("fedadc_fused_axpy_leaves", rows.ctypes.data, len(xs),
                 out.data_ptr(), a, DTYPE_CODE[dtype], stream())
    fused_axpy_leaves.launches += launches
    return [out.as_strided(shape, st, off) for shape, st, off in views]


# sweep plans by (leaf shapes, dtype, tile): a run sweeps a handful of trees
_PLANS = {}


def sweep_table(shapes, dtype, device, tile):
    """An elementwise sweep's table for outputs of ``shapes`` in blocks of
    ``tile`` elements: (a copy of the planned rows, whose output column
    holds byte offsets into the buffer, the output buffer, the views'
    geometry, the launches).  The caller fills the input pointers
    (columns 0 and 1) and passes the buffer's pointer."""
    key = (shapes, dtype, tile)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS.setdefault(key, _sweep_plan(shapes, dtype, tile))
    template, total, views, launches = plan
    return (template.copy(), torch.empty(total, dtype=dtype, device=device),
            views, launches)


def fused_axpy(x: torch.Tensor, y: torch.Tensor, a: float) -> torch.Tensor:
    """x + a·y on one leaf: a table of one."""
    return fused_axpy_leaves([x], [y], a)[0]


def local_update(theta: torch.Tensor, g: torch.Tensor, m_bar: torch.Tensor,
                 eta: float) -> torch.Tensor:
    """θ − η·(g + m̄), the FedADC heavy-ball local step."""
    check_operands("local_update", theta, g, m_bar)
    out = torch.empty_like(theta)
    if theta.numel():
        build.launch("fedadc_local_update", theta.data_ptr(), g.data_ptr(),
                     m_bar.data_ptr(), out.data_ptr(), theta.numel(), eta,
                     DTYPE_CODE[theta.dtype], stream())
        local_update.launches += 1
    return out


def server_update(theta: torch.Tensor, m: torch.Tensor,
                  delta_bar: torch.Tensor, gamma: float, alpha_eta: float):
    """m' = Δ̄ + γ·m ; θ' = θ − αη·m'  -> (θ', m').  ``m`` and ``delta_bar``
    are fp32 whatever θ's dtype; θ' is rounded to θ's dtype on write."""
    check_operands("server_update", theta)
    check_operands("server_update", m, delta_bar, dtype=torch.float32,
                   shape=theta.shape, device=theta.get_device())
    theta_out = torch.empty_like(theta)
    m_out = torch.empty_like(m)
    if theta.numel():
        build.launch("fedadc_server_update", theta.data_ptr(), m.data_ptr(),
                     delta_bar.data_ptr(), theta_out.data_ptr(),
                     m_out.data_ptr(), theta.numel(), gamma, alpha_eta,
                     DTYPE_CODE[theta.dtype], stream())
        server_update.launches += 1
    return theta_out, m_out


fused_axpy_leaves.launches = 0
local_update.launches = 0
server_update.launches = 0
