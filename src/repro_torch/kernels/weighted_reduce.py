"""Fused weighted-delta-reduce kernel on the card (CUDA C++ in
``csrc/fedadc_kernels.cu``), the counterpart of the Pallas
``weighted_reduce_2d`` in the JAX package's ``kernels/weighted_reduce.py``.

Σ_k w_k·Δ_k over K stacked deltas: each thread owns one element (or one
16-byte vector of them) and walks the K clients in order with an fp32
register sum, so the summation order is fixed, no atomics are needed, and
the result is rounded to the delta dtype once, on write.  The TPU's row
blocks and VMEM budget have no counterpart: the kernel reads each (K, n)
stack as one flat buffer of any n.

``weighted_reduce_leaves`` takes a whole aggregate, every leaf of a tree,
as one leaf table (``leaf_table.py``), planned as the axpy's sweep is but
in blocks of 4 KB of output: one launch for up to 64 leaves, the outputs
views of one buffer.  Its ``launches`` counts those launches.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import (DTYPE_CODE, check_operands,
                                               stream, sweep_table)

# output bytes a block reduces: kReduceBytes in csrc/fedadc_kernels.cu
REDUCE_BYTES = 4096


def weighted_reduce_leaves(stacks, weights: torch.Tensor):
    """stacks: leaves (K, ...) of one dtype (fp32 or bf16) and one card,
    weights (K,) fp32 -> [Σ_k w_k·Δ_k of each leaf], shape ``stack.shape[1:]``
    and the stacks' dtype, as views of one buffer.  Weights are applied as
    given (normalise upstream for a weighted mean)."""
    if not stacks:
        return []
    first = stacks[0]
    check_operands("weighted_reduce", first)
    if first.dim() == 0:
        raise ValueError("weighted_reduce: a stack needs a leading client "
                         "axis")
    k, dev = first.shape[0], first.get_device()
    check_operands("weighted_reduce", weights, dtype=torch.float32,
                   shape=(k,), device=dev)
    for d in stacks:
        if (d.get_device() != dev or d.dtype is not first.dtype
                or not d.is_contiguous() or d.dim() == 0
                or d.shape[0] != k):
            check_operands("weighted_reduce", d, dtype=first.dtype,
                           shape=(k,) + tuple(d.shape[1:]), device=dev)
            raise ValueError(f"weighted_reduce: a stack of {tuple(d.shape)} "
                             f"where {k} clients are stacked")
    shapes = tuple(d.shape[1:] for d in stacks)
    rows, out, outs, launches = sweep_table(
        shapes, first.dtype, first.device,
        REDUCE_BYTES // first.element_size())
    rows[:, 0] = [d.data_ptr() for d in stacks]
    build.launch("fedadc_weighted_reduce_leaves", rows.ctypes.data,
                 len(stacks), out.data_ptr(), weights.data_ptr(), k,
                 DTYPE_CODE[first.dtype], stream())
    weighted_reduce_leaves.launches += launches
    return outs


def weighted_reduce(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """deltas (K, ...) fp32 or bf16, weights (K,) fp32 -> Σ_k w_k·Δ_k with
    shape deltas.shape[1:] and the deltas' dtype: a table of one."""
    return weighted_reduce_leaves([deltas], weights)[0]


weighted_reduce_leaves.launches = 0
