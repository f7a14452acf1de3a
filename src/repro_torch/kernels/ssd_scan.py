"""The Mamba2 chunked SSD scan on the card (CUDA C++ in
``csrc/ssd_kernels.cu``).

``ssd_scan`` is the counterpart of the Pallas ``ssd_scan`` in the JAX
package's ``kernels/ssd_scan.py``: the intra-chunk (C·Bᵀ ⊙ exp-decay ⊙
causal)·x plus the carried state's exp(cumsum a)·(C·h), with h folded
across chunks in order.  Like the Pallas kernel it takes its operands
pre-gated — x already scaled by dt, a the per-step log decay — and leaves
the D skip to its caller (``ops.ssd_scan``).  It reads the model's (b, L,
H, ·) layout as it is; a ragged last chunk (L not a multiple of the chunk)
is masked in the kernel.

The wrapper checks its operands and raises on what the kernel does not
take, allocates the output with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and counts its launches in
``ssd_scan.launches``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

MAX_P = MAX_N = 64
MAX_CHUNK = 256


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int, out_dtype: torch.dtype
             ) -> torch.Tensor:
    """xdt (b, L, H, P) fp32, a (b, L, H) fp32, B/C (b, L, H, N) fp32 or
    bf16 (one dtype), P and N at most 64, 1 <= chunk <= 256 -> y (b, L, H,
    P) in ``out_dtype`` (fp32 or bf16), without the D term."""
    check_operands("ssd_scan", xdt, dtype=torch.float32)
    if xdt.dim() != 4:
        raise ValueError("ssd_scan: x must be (b, L, H, P)")
    b, L, H, P = xdt.shape
    N = B.shape[-1]
    if not (1 <= P <= MAX_P and 1 <= N <= MAX_N
            and 1 <= chunk <= MAX_CHUNK):
        raise ValueError(f"ssd_scan: P {P} and N {N} must be in [1, 64] and "
                         f"the chunk {chunk} in [1, 256]")
    dev = xdt.get_device()
    check_operands("ssd_scan", a, dtype=torch.float32, shape=(b, L, H),
                   device=dev)
    check_operands("ssd_scan", B, C, shape=(b, L, H, N), device=dev)
    if out_dtype not in DTYPE_CODE:
        raise ValueError(f"ssd_scan: output dtype {out_dtype} not supported")
    y = torch.empty((b, L, H, P), dtype=out_dtype, device=xdt.device)
    if y.numel():
        build.launch("fedadc_ssd_scan", xdt.data_ptr(), a.data_ptr(),
                     B.data_ptr(), C.data_ptr(), y.data_ptr(), b, L, H, P, N,
                     chunk, DTYPE_CODE[B.dtype], DTYPE_CODE[out_dtype],
                     stream())
        ssd_scan.launches += 1
    return y


ssd_scan.launches = 0
