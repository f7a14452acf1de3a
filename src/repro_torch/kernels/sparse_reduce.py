"""The sparse server aggregate on the card (CUDA C++ in
``csrc/compress_kernels.cu``), the counterpart of the Pallas
``sparse_reduce_2d`` in the JAX package's ``kernels/sparse_reduce.py``.

    out_l[idx_{c,j}] += w_c · values_{l,c,j}      (K·k_l adds, not K·n_l)

For every leaf l of an aggregate, the K stacked (value, index) wires are
summed straight into one dense leaf in fp32, client by client in order
and, within a client, in pair order, so a duplicate index adds again
(segment-sum semantics); the result is cast to the output dtype once, on
write.  The kernels use no atomics on the sums, so the order is fixed and
each leaf equals its plain version (``ref.sparse_weighted_delta_reduce``)
bit for bit.  Indices outside [0, n) add nothing.

One call takes every leaf of an aggregate as a leaf table
(``leaf_table.py``) and runs four device kernels (count, scan, scatter,
apply: the pairs binned by output tile, in order) per group of 64 leaves;
``sparse_reduce_leaves.launches`` counts calls, one an aggregate.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import build, leaf_table
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

TILE = 8192           # output elements a tile: kTile in csrc/compress_kernels.cu
CHUNK = 8192          # pairs a chunk: kChunk
# the widest leaf's tiles that the scatter's shared memory holds: 98,432 B
# for the staged chunk, 40 B a tile
MAX_TILES = (232448 - 98432) // 40


def _plan(shapes, ks, n_clients, esize):
    """What a call over leaves of ``shapes`` with k_l pairs a client needs
    besides the pointers, computed once per tree: the table rows with each
    output's byte offset in place of its pointer, the output length, each
    view's (shape, strides, offset), and the scratch layout (count
    matrix, its scan with one more entry a group, the bins at 8 B a pair)
    as int32 offsets and a length; None if no leaf has an element."""
    fields, units, views, off = [], [], [], 0
    for shape, k in zip(shapes, ks):
        n = math.prod(shape)
        if n >= 2 ** 31 or leaf_table.cdiv(n, TILE) > MAX_TILES:
            raise ValueError(f"sparse_reduce: a leaf of {n} elements is "
                             f"above the kernel's {MAX_TILES * TILE}")
        tiles = leaf_table.cdiv(n, TILE)
        chunks = leaf_table.cdiv(n_clients * k, CHUNK)
        fields.append((0, 0, off * esize, n, k))
        units.append((tiles, chunks, tiles * chunks, n_clients * k))
        views.append((shape, leaf_table.strides(shape), off))
        off += leaf_table.padded(n)
    rows, totals = leaf_table.pack(fields, units)
    if any(t[3] >= 2 ** 31 for t in totals):
        raise ValueError("sparse_reduce: 2**31 pairs or more in one call")
    n_mat = sum(t[2] for t in totals)
    scan_at = n_mat
    bins_at = leaf_table.padded(scan_at + n_mat + len(totals))
    scratch = bins_at + 2 * sum(t[3] for t in totals)
    return (rows, off, views,
            (scan_at, bins_at, scratch) if sum(t[0] for t in totals)
            else None)


def sparse_reduce_leaves(values, indices, weights: torch.Tensor, shapes,
                         dtype):
    """values[l] (K, k_l) fp32 or bf16 (one dtype), indices[l] (K, k_l)
    int32 flat indices into a leaf of ``shapes[l]``, weights (K,) fp32 ->
    for each leaf Σ_c w_c·scatter(v_c @ i_c) of its shape and ``dtype``
    (fp32 or bf16), as views of one buffer."""
    if not (len(values) == len(indices) == len(shapes)):
        raise ValueError("sparse_reduce: values, indices and shapes differ "
                         "in length")
    if not values:
        return []
    vdt = values[0].dtype
    if vdt not in DTYPE_CODE or dtype not in DTYPE_CODE:
        raise ValueError(f"sparse_reduce: dtypes {vdt} -> {dtype} not "
                         f"supported (float32, bfloat16)")
    n_clients = weights.shape[0] if weights.dim() == 1 else -1
    check_operands("sparse_reduce", weights, dtype=torch.float32,
                   shape=(n_clients,))
    dev = weights.get_device()
    for v, i in zip(values, indices):
        if (v.get_device() != dev or i.get_device() != dev
                or v.dtype is not vdt or i.dtype is not torch.int32
                or not v.is_contiguous() or not i.is_contiguous()):
            check_operands("sparse_reduce", v, dtype=vdt, device=dev)
            check_operands("sparse_reduce", i, dtype=torch.int32,
                           device=dev)
            raise ValueError(f"sparse_reduce: values {v.dtype} and indices "
                             f"{i.dtype} where {vdt} and int32 are needed")
    wire = tuple(v.shape for v in values)
    if tuple(i.shape for i in indices) != wire:
        raise ValueError("sparse_reduce: values and indices differ in shape")
    key = (tuple(shapes), wire, vdt, dtype)
    plan = _PLANS.get(key)
    if plan is None:
        if any(len(s) != 2 or s[0] != n_clients for s in wire):
            raise ValueError(f"sparse_reduce: values and indices must be "
                             f"({n_clients}, k) each, got {wire}")
        plan = _PLANS.setdefault(key, _plan(
            [tuple(s) for s in shapes], [s[1] for s in wire], n_clients,
            dtype.itemsize))
    template, total, views, scratch = plan
    out = torch.empty(total, dtype=dtype, device=weights.device)
    if scratch is not None:
        scan_at, bins_at, length = scratch
        buf = torch.empty(length, dtype=torch.int32, device=weights.device)
        base = buf.data_ptr()
        rows = template.copy()
        rows[:, 0] = [v.data_ptr() for v in values]
        rows[:, 1] = [i.data_ptr() for i in indices]
        rows[:, 2] += out.data_ptr()
        build.launch("fedadc_sparse_reduce_leaves", rows.ctypes.data,
                     len(values), weights.data_ptr(), n_clients, base,
                     base + 4 * scan_at, base + 4 * bins_at,
                     DTYPE_CODE[vdt], DTYPE_CODE[dtype], stream())
        sparse_reduce_leaves.launches += 1
    return [out.as_strided(shape, st, off) for shape, st, off in views]


# call plans by (leaf shapes, wire shapes, dtypes)
_PLANS = {}


def sparse_reduce(values: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor, shape, dtype) -> torch.Tensor:
    """One leaf: values (K, k), indices (K, k) int32, weights (K,) fp32 ->
    Σ_c w_c·scatter(v_c @ i_c) of ``shape`` and ``dtype``; a table of
    one."""
    return sparse_reduce_leaves([values], [indices], weights, [shape],
                                dtype)[0]


sparse_reduce_leaves.launches = 0
