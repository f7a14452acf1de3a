"""Fused weighted-delta-reduce kernel on the card (CUDA C++ in
``csrc/fedadc_kernels.cu``), the counterpart of the Pallas
``weighted_reduce_2d`` in the JAX package's ``kernels/weighted_reduce.py``.

Σ_k w_k·Δ_k over K stacked deltas: each thread owns one element and walks
the K clients in order with an fp32 register sum, so the summation order is
fixed, no atomics are needed, and the result is rounded to the delta dtype
once, on write.  The TPU's row blocks and VMEM budget have no counterpart:
the kernel reads the (K, n) stack as one flat buffer of any n.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream


def weighted_reduce(deltas: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """deltas (K, ...) fp32 or bf16, weights (K,) fp32 -> Σ_k w_k·Δ_k with
    shape deltas.shape[1:] and the deltas' dtype.  Weights are applied as
    given (normalise upstream for a weighted mean)."""
    check_operands("weighted_reduce", deltas)
    k = deltas.shape[0]
    check_operands("weighted_reduce", weights, dtype=torch.float32,
                   shape=(k,), device=deltas.get_device())
    out = torch.empty(deltas.shape[1:], dtype=deltas.dtype,
                      device=deltas.device)
    n = out.numel()
    if n:
        build.launch("fedadc_weighted_reduce", deltas.data_ptr(),
                     weights.data_ptr(), out.data_ptr(), k, n,
                     DTYPE_CODE[deltas.dtype], stream())
        weighted_reduce.launches += 1
    return out


weighted_reduce.launches = 0
