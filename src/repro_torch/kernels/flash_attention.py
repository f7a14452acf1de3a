"""Causal GQA flash attention on the card (CUDA C++ in
``csrc/attention_kernels.cu``).

``flash_attention`` is the counterpart of the Pallas ``flash_attention`` in
the JAX package's ``kernels/flash_attention.py``: softmax(q·kᵀ/√D)·v with
the causal mask and an optional sliding window, head h reading kv head
h // (H/Hk), fp32 softmax and sums, output in q's dtype.  bf16 operands
take the tensor-core kernel (wgmma, P rounded to bf16 before P·V); fp32
ones the CUDA-core kernel.  It takes the model's (B, L, H, D) layout as it
is; the TPU kernel's (B, H, L, D) layout and the transposes around it have
no counterpart here.

The wrapper checks its operands and raises on what the kernel does not
take, copies an operand whose start is not 16-byte aligned (the kernels
copy 16 bytes at a time), allocates the output with ``torch.empty``,
launches on the current stream, raises if the launch reports an error, and
counts its launches in ``flash_attention.launches``.  There is no backward:
``ops.flash_attention`` refuses operands that need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

HEAD_DIMS = (64, 128)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, L, H, D), k/v (B, L, Hk, D), one dtype (fp32 or bf16), D 64 or
    128, H a multiple of Hk -> (B, L, H, D) in q's dtype."""
    check_operands("flash_attention", q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, L, H, D)")
    B, L, H, D = q.shape
    Hk = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not supported "
                         f"{HEAD_DIMS}")
    if Hk == 0 or H % Hk:
        raise ValueError(f"flash_attention: {H} heads do not share {Hk} kv "
                         f"heads evenly")
    check_operands("flash_attention", k, v, dtype=q.dtype, shape=(B, L, Hk, D),
                   device=q.get_device())
    o = torch.empty_like(q)
    if o.numel():
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        build.launch("fedadc_flash_attention", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), B, L, H, Hk, D, int(causal),
                     int(window), D ** -0.5, DTYPE_CODE[q.dtype], stream())
        flash_attention.launches += 1
    return o


flash_attention.launches = 0
