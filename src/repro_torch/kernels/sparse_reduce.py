"""The sparse server aggregate on the card (CUDA C++ in
``csrc/compress_kernels.cu``), the counterpart of the Pallas
``sparse_reduce_2d`` in the JAX package's ``kernels/sparse_reduce.py``.

    out[idx_{c,j}] += w_c · values_{c,j}      (K·k adds, not K·d)

The K stacked (value, index) wires are summed straight into one dense leaf
in fp32, client by client in order and, within a client, in pair order, so
a duplicate index adds again (segment-sum semantics); the result is cast to
the output dtype once, on write.  The kernel uses no atomics on the sum, so
the order is fixed and it equals its plain version
(``ref.sparse_weighted_delta_reduce``) bit for bit.  Indices outside
[0, n) add nothing.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream


def sparse_reduce(values: torch.Tensor, indices: torch.Tensor,
                  weights: torch.Tensor, shape, dtype) -> torch.Tensor:
    """values (K, k) fp32 or bf16, indices (K, k) int32 flat indices into a
    leaf of ``shape``, weights (K,) fp32 -> Σ_c w_c·scatter(v_c @ i_c) of
    ``shape`` and ``dtype`` (fp32 or bf16)."""
    check_operands("sparse_reduce", values)
    if values.dim() != 2:
        raise ValueError(f"sparse_reduce: values must be (K, k), got "
                         f"{tuple(values.shape)}")
    n_clients, k = values.shape
    dev = values.get_device()
    if not (indices.is_cuda and indices.get_device() == dev
            and indices.dtype == torch.int32
            and indices.shape == values.shape and indices.is_contiguous()):
        raise ValueError(f"sparse_reduce: indices must be contiguous int32 "
                         f"{tuple(values.shape)} on cuda:{dev}, got "
                         f"{indices.dtype} {tuple(indices.shape)} on "
                         f"{indices.device}")
    check_operands("sparse_reduce", weights, dtype=torch.float32,
                   shape=(n_clients,), device=dev)
    if dtype not in DTYPE_CODE:
        raise ValueError(f"sparse_reduce: output dtype {dtype} not supported")
    out = torch.empty(shape, dtype=dtype, device=values.device)
    n = out.numel()
    if k == 0 or n_clients == 0:
        return out.zero_()
    if n:
        build.launch("fedadc_sparse_reduce", values.data_ptr(),
                     indices.data_ptr(), weights.data_ptr(), out.data_ptr(),
                     n_clients, k, n, DTYPE_CODE[values.dtype],
                     DTYPE_CODE[dtype], stream())
        sparse_reduce.launches += 1
    return out


sparse_reduce.launches = 0
