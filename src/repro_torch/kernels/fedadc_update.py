"""Fused FedADC update kernels on the card (CUDA C++ in
``csrc/fedadc_kernels.cu``).

Counterparts of the Pallas kernels in the JAX package's
``kernels/fedadc_update.py``: ``fused_axpy_leaves`` (``fused_axpy_2d``),
``local_update_leaves`` (``local_update_2d``) and ``server_update_leaves``
(``server_update_2d``, with the scale that forms Δ̄ = mean_delta/η folded
in).  Each takes a whole sweep, every leaf of a tree, as one leaf table
(``leaf_table.py``): one launch for up to 64 leaves.  A leaf is any
contiguous CUDA tensor — one leaf, or one leaf stacked over the round's
clients — read as a flat buffer; the TPU's (rows, 128) lane tiling has no
counterpart here.  ``fused_axpy``, ``local_update`` and ``server_update``
are tables of one leaf.

Every wrapper checks its operands and raises on what the kernel does not
take, allocates its outputs with ``torch.empty`` (one buffer per output
role, the leaves' outputs views of it), launches on the current stream,
raises if the launch reports an error, and counts its device launches in a
plain integer attribute (``*_leaves.launches``: one a sweep of up to 64
leaves) so a run can show that it went through the kernel.
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
UPDATE_TILE = 2048    # elements a block: kUpdateTile in the same


def _sweep_plan(shapes, dtype, tile, inputs=2, fp32_output=False):
    """What an elementwise sweep writing leaves of ``shapes`` in blocks of
    ``tile`` elements (the axpy, the weighted reduce, the updates) needs
    besides the pointers, computed once per tree: the table rows (``inputs``
    zeroed pointer columns, each output's byte offset in its buffer — one
    in ``dtype``, then one in fp32 where ``fp32_output`` — n, the end of
    the leaf's blocks), the buffers' length in elements, each view's
    (shape, strides, offset) and the launches the table takes."""
    esizes = (dtype.itemsize,) + (
        (4,) if fp32_output else ())
    fields, units, geometry, off = [], [], [], 0
    for shape in shapes:
        n = math.prod(shape)
        fields.append((0,) * inputs + tuple(off * e for e in esizes) + (n,))
        units.append((leaf_table.cdiv(n, tile),))
        geometry.append((shape, leaf_table.strides(shape), off))
        off += leaf_table.padded(n)
    rows, totals = leaf_table.pack(fields, units)
    return rows, off, geometry, sum(1 for t in totals if t[0])


# sweep plans by (leaf shapes, dtype, tile, layout): a run sweeps a handful
# of trees
_PLANS = {}


def sweep_plan(shapes, dtype, tile, inputs=2, fp32_output=False):
    """``_sweep_plan``, made once per key -> (the rows, which the caller
    copies before it fills the input pointers, the buffers' length, the
    views' geometry, the launches)."""
    key = (shapes, dtype, tile, inputs, fp32_output)
    plan = _PLANS.get(key)
    if plan is None:
        plan = _PLANS.setdefault(key, _sweep_plan(shapes, dtype, tile, inputs,
                                                  fp32_output))
    return plan


def outputs(total, geometry, dtype, device):
    """(One output buffer of ``total`` elements, the leaves' outputs as
    views of it at ``geometry``); a sweep of one leaf allocates that leaf
    itself, which needs no view."""
    if len(geometry) == 1:
        out = torch.empty(geometry[0][0], dtype=dtype, device=device)
        return out, [out]
    buf = torch.empty(total, dtype=dtype, device=device)
    return buf, [buf.as_strided(shape, st, off) for shape, st, off in geometry]


def sweep_table(shapes, dtype, device, tile):
    """An elementwise sweep's table for outputs of ``shapes`` in blocks of
    ``tile`` elements: (a copy of the planned rows, whose output column
    holds byte offsets into the buffer, the output buffer, the outputs,
    the launches).  The caller fills the input pointers (columns 0 and 1)
    and passes the buffer's pointer."""
    template, total, geometry, launches = sweep_plan(shapes, dtype, tile)
    return (template.copy(), *outputs(total, geometry, dtype, device),
            launches)


def n_leaves(name, lists) -> int:
    """The common length of a sweep's operand lists; raises if they
    differ."""
    lengths = [len(leaves) for leaves in lists]
    if len(set(lengths)) != 1:
        raise ValueError(f"{name}: operand lists of {lengths} leaves")
    return lengths[0]


def check_leaves(name, lists, dtypes):
    """Raise unless ``lists[j][i]`` is a contiguous tensor of
    ``lists[0][i]``'s shape in dtype ``dtypes[j]`` (fp32 or bf16) for every
    list j and leaf i, all on the card of the first leaf.  -> the leaves'
    shapes."""
    for dt in dtypes:
        if dt not in DTYPE_CODE:
            raise ValueError(f"{name}: dtype {dt} not supported "
                             f"(float32, bfloat16)")
    dev = lists[0][0].get_device()
    shapes = tuple(t.shape for t in lists[0])
    for leaves, dt in zip(lists, dtypes):
        for t, shape in zip(leaves, shapes):
            if (t.get_device() != dev or dev < 0 or t.dtype is not dt
                    or t.shape != shape or not t.is_contiguous()):
                check_operands(name, t, dtype=dt, shape=shape, device=dev)
                raise ValueError(f"{name}: operands on cuda:{dev} and "
                                 f"{t.device}")
    return shapes


def fused_axpy_leaves(xs, ys, a: float):
    """x_i + a·y_i for every pair of leaves, in one launch a group of 64
    leaves -> the outputs, in order, as views of one buffer.  The leaves
    may differ in shape but share one dtype and device.  The host work is
    one lean pass over the leaves; the rest is planned once per tree."""
    if not n_leaves("fused_axpy", (xs, ys)):
        return []
    dtype = xs[0].dtype
    shapes = check_leaves("fused_axpy", (xs, ys), (dtype, dtype))
    rows, out, outs, launches = sweep_table(shapes, dtype, xs[0].device,
                                            AXPY_TILE)
    rows[:, 0] = [x.data_ptr() for x in xs]
    rows[:, 1] = [y.data_ptr() for y in ys]
    build.launch("fedadc_fused_axpy_leaves", rows.ctypes.data, len(xs),
                 out.data_ptr(), a, DTYPE_CODE[dtype], stream())
    fused_axpy_leaves.launches += launches
    return outs


def _update_rows(name, lists, dtypes):
    """Check a sweep of the update kernels (three operand lists of one
    length, ``dtypes`` theirs) and fill its table -> (the rows, the
    buffers' length, the views' geometry, the launches)."""
    shapes = check_leaves(name, lists, dtypes)
    template, total, geometry, launches = sweep_plan(
        shapes, dtypes[0], UPDATE_TILE, inputs=3, fp32_output=True)
    rows = template.copy()
    for j, leaves in enumerate(lists):
        rows[:, j] = [t.data_ptr() for t in leaves]
    return rows, total, geometry, launches


def local_update_leaves(thetas, gs, m_bars, eta: float):
    """θ_i − η·(g_i + m̄_i) for every leaf (the FedADC heavy-ball local
    step), all three in one dtype (fp32 or bf16) on one card -> the new
    θ leaves, in order, as views of one buffer; one launch a group of 64
    leaves."""
    if not n_leaves("local_update", (thetas, gs, m_bars)):
        return []
    dtype = thetas[0].dtype
    rows, total, geometry, launches = _update_rows(
        "local_update", (thetas, gs, m_bars), (dtype,) * 3)
    out, outs = outputs(total, geometry, dtype, thetas[0].device)
    build.launch("fedadc_local_update_leaves", rows.ctypes.data, len(thetas),
                 out.data_ptr(), eta, DTYPE_CODE[dtype], stream())
    local_update_leaves.launches += launches
    return outs


def server_update_leaves(thetas, ms, deltas, gamma: float, alpha_eta: float,
                         scale: float = 1.0):
    """The FedADC/SlowMo server step for every leaf: Δ̄ = scale·Δ in fp32,
    m' = Δ̄ + γ·m, θ' = θ − αη·m'.  θ in fp32 or bf16, m fp32, Δ in fp32 or
    bf16 (one dtype each over the sweep), all on one card -> (the θ'
    leaves in θ's dtype, the m' leaves in fp32), each list views of one
    buffer; one launch a group of 64 leaves.  ``scale`` 1 is the Pallas
    kernel's step on a given Δ̄; the strategies pass mean_delta and 1/η."""
    if not n_leaves("server_update", (thetas, ms, deltas)):
        return [], []
    dtype, ddt = thetas[0].dtype, deltas[0].dtype
    rows, total, geometry, launches = _update_rows(
        "server_update", (thetas, ms, deltas), (dtype, torch.float32, ddt))
    theta_out, thetas_new = outputs(total, geometry, dtype, thetas[0].device)
    m_out, ms_new = outputs(total, geometry, torch.float32, thetas[0].device)
    build.launch("fedadc_server_update_leaves", rows.ctypes.data,
                 len(thetas), theta_out.data_ptr(), m_out.data_ptr(), gamma,
                 alpha_eta, scale, DTYPE_CODE[dtype], DTYPE_CODE[ddt],
                 stream())
    server_update_leaves.launches += launches
    return thetas_new, ms_new


def fused_axpy(x: torch.Tensor, y: torch.Tensor, a: float) -> torch.Tensor:
    """x + a·y on one leaf: a table of one."""
    return fused_axpy_leaves([x], [y], a)[0]


def local_update(theta: torch.Tensor, g: torch.Tensor, m_bar: torch.Tensor,
                 eta: float) -> torch.Tensor:
    """θ − η·(g + m̄) on one leaf: a table of one."""
    return local_update_leaves([theta], [g], [m_bar], eta)[0]


def server_update(theta: torch.Tensor, m: torch.Tensor,
                  delta_bar: torch.Tensor, gamma: float, alpha_eta: float):
    """m' = Δ̄ + γ·m ; θ' = θ − αη·m' on one leaf -> (θ', m'): a table of
    one.  ``m`` is fp32 whatever θ's dtype; θ' is rounded to θ's dtype on
    write."""
    (theta_new,), (m_new,) = server_update_leaves([theta], [m], [delta_bar],
                                                  gamma, alpha_eta)
    return theta_new, m_new


fused_axpy_leaves.launches = 0
local_update_leaves.launches = 0
server_update_leaves.launches = 0
