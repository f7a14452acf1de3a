"""Delta-compression kernels on the card (CUDA C++ in
``csrc/compress_kernels.cu``), the counterparts of the Pallas kernels in the
JAX package's ``kernels/compress.py``: ``threshold_select_leaves``
(``threshold_select_2d``) and ``qsgd_leaves`` (``qsgd_2d``), each over
every leaf of a sweep as one leaf table (``leaf_table.py``, one launch per
64 leaves), QSGD with each row's scale computed in the call or given;
``threshold_select`` and ``qsgd`` are tables of one leaf.

Each emits the reconstruction q AND the residual v − q from one pass over
the input.  Both take leaves stacked over the round's clients, (B, ...),
with one scalar per client row — the top-k threshold τ or the QSGD scale —
so a stacked leaf is a share of one launch, not B.  The thresholds are
computed outside the kernel (``torch.topk``), as ``lax.top_k`` is in the
reference.

Every wrapper checks its operands and raises on what the kernel does not
take, allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and counts its launches in a
plain integer attribute.
"""
from __future__ import annotations

import torch

import math

from repro_torch.kernels import build, leaf_table
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

QSGD_TILE = 4096      # elements of a row a block: kQsgdTile in the .cu


def _row_scalars(name, v, scalars):
    """Check the per-row scalars -> (rows, elements per row)."""
    if v.dim() == 0:
        raise ValueError(f"{name}: needs a leaf stacked over clients (B, ...)")
    rows = v.shape[0]
    check_operands(name, scalars, dtype=v.dtype, shape=(rows,),
                   device=v.get_device())
    return rows, v.numel() // rows if rows else 0


def threshold_select(v: torch.Tensor, thresh: torch.Tensor):
    """q = v·1[|v| ≥ τ_row], r = v − q for v (B, ...) and τ (B,) in v's
    dtype -> (q, r): ``threshold_select_leaves`` over a table of one leaf
    (τ widened to fp32, exactly)."""
    check_operands("threshold_select", v)
    _row_scalars("threshold_select", v, thresh)
    (q,), (r,) = threshold_select_leaves([v], thresh.float())
    return q, r


def qsgd(v: torch.Tensor, u: torch.Tensor, scale: torch.Tensor, s: int):
    """QSGD quantise-dequantise of one leaf v (B, ...) with the uniform draw
    u (v's shape and dtype), the per-row scale (B,) in v's dtype and ``s``
    levels -> (q, r): ``qsgd_leaves`` over a table of one leaf with the
    scales given."""
    check_operands("qsgd", v, u)
    _row_scalars("qsgd", v, scale)
    (q,), (r,) = qsgd_leaves([v], [u], s, scales=scale.float())
    return q, r


def _qsgd_plan(shapes, dtype):
    """What a QSGD or threshold-select sweep over stacked leaves of
    ``shapes`` needs besides the pointers, computed once per tree: the
    table rows with the q and r byte offsets into one output buffer (q's of
    every leaf, then r's), the buffer's half length, each view's (shape,
    strides, offset) and the per-group totals of (rows, blocks)."""
    esize = torch.empty((), dtype=dtype).element_size()
    fields, units, views, off = [], [], [], 0
    for shape in shapes:
        rows, n = shape[0], math.prod(shape[1:])
        fields.append([0, 0, off * esize, 0, n])
        units.append((rows, rows * leaf_table.cdiv(n, QSGD_TILE)))
        views.append((shape, leaf_table.strides(shape), off))
        off += leaf_table.padded(rows * n)
    for f in fields:
        f[3] = f[2] + off * esize
    rows, totals = leaf_table.pack(fields, units)
    return rows, off, views, totals


_QSGD_PLANS = {}


def _table_plan(name, vs, us):
    """Check a QSGD or select sweep's leaves (and draws, where given) and
    get its plan -> (the rows with the pointers filled in, half, views,
    totals)."""
    dtype, dev = vs[0].dtype, vs[0].get_device()
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    for v, u in zip(vs, us or vs):
        if (v.dim() == 0 or u.shape != v.shape or v.get_device() != dev
                or u.get_device() != dev or dev < 0 or v.dtype is not dtype
                or u.dtype is not dtype or not v.is_contiguous()
                or not u.is_contiguous()):
            if v.dim() == 0:
                raise ValueError(f"{name}: needs leaves stacked over clients")
            check_operands(name, v, u, dtype=dtype, shape=v.shape,
                           device=dev)
            raise ValueError(f"{name}: operands on cuda:{dev} and "
                             f"{v.device}")
    key = (tuple(tuple(v.shape) for v in vs), dtype)
    plan = _QSGD_PLANS.get(key)
    if plan is None:
        plan = _QSGD_PLANS.setdefault(key, _qsgd_plan(key[0], dtype))
    template, half, views, totals = plan
    rows = template.copy()
    rows[:, 0] = [v.data_ptr() for v in vs]
    if us is not None:
        rows[:, 1] = [u.data_ptr() for u in us]
    return rows, half, views, totals


def _views(out, half, views):
    """The q and r views of a sweep's output buffer -> (qs, rs)."""
    return ([out.as_strided(sh, st, off) for sh, st, off in views],
            [out.as_strided(sh, st, half + off) for sh, st, off in views])


def threshold_select_leaves(vs, taus: torch.Tensor):
    """The top-k threshold select of every leaf of a sweep: vs[i] (B_i, ...)
    stacked over client rows, one dtype (fp32 or bf16) and card for all;
    ``taus`` one fp32 threshold per row of every leaf in order.  q = v where
    |v| ≥ τ_row, else 0; r = v − q.  -> (qs, rs), views of one buffer; one
    launch a group of 64 leaves."""
    if not vs:
        return [], []
    rows, half, views, totals = _table_plan("threshold_select", vs, None)
    n_rows = sum(t[0] for t in totals)
    check_operands("threshold_select", taus, dtype=torch.float32,
                   shape=(n_rows,), device=vs[0].get_device())
    out = torch.empty(2 * half, dtype=vs[0].dtype, device=vs[0].device)
    build.launch("fedadc_threshold_select_leaves", rows.ctypes.data, len(vs),
                 out.data_ptr(), taus.data_ptr(), DTYPE_CODE[vs[0].dtype],
                 stream())
    threshold_select_leaves.launches += sum(1 for t in totals if t[1])
    return _views(out, half, views)


def qsgd_leaves(vs, us, s: int, scales=None):
    """QSGD of every leaf of a sweep: vs[i] (B_i, ...) stacked over client
    rows, us[i] the uniform draws of its shape, one dtype (fp32 or bf16) and
    card for all, ``s`` levels.  Each row's scale is its max |v|, computed
    in the call, or taken from ``scales``: one fp32 per row of every leaf
    in order.  -> (qs, rs), views of one buffer; one launch a group of 64
    leaves."""
    if len(vs) != len(us):
        raise ValueError(f"qsgd: {len(vs)} v leaves, {len(us)} draws")
    if not vs:
        return [], []
    rows, half, views, totals = _table_plan("qsgd", vs, us)
    dtype = vs[0].dtype
    out = torch.empty(2 * half, dtype=dtype, device=vs[0].device)
    n_rows = sum(t[0] for t in totals)
    compute = scales is None
    if compute:
        scales = torch.empty(n_rows, dtype=torch.float32, device=out.device)
    else:
        check_operands("qsgd", scales, dtype=torch.float32, shape=(n_rows,),
                       device=vs[0].get_device())
    build.launch("fedadc_qsgd_leaves", rows.ctypes.data, len(vs),
                 out.data_ptr(), scales.data_ptr(), int(compute), float(s),
                 DTYPE_CODE[dtype], stream())
    qsgd_leaves.launches += sum(1 for t in totals if t[1])
    return _views(out, half, views)


threshold_select_leaves.launches = 0
qsgd_leaves.launches = 0
