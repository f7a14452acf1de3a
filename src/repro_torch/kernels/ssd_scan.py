"""The Mamba2 chunked SSD scan on the card (CUDA C++ in
``csrc/ssd_kernels.cu``).

``ssd_scan`` is the counterpart of the Pallas ``ssd_scan`` in the JAX
package's ``kernels/ssd_scan.py``: the intra-chunk (C·Bᵀ ⊙ exp-decay ⊙
causal)·x plus the carried state's exp(cumsum a)·(C·h).  Like the Pallas
kernel it takes its operands pre-gated — x already scaled by dt, a the
per-step log decay — and leaves the D skip to its caller
(``ops.ssd_scan``).  It reads the model's (b, L, H, ·) layout as it is; a
ragged last chunk (L not a multiple of the chunk) is masked in the kernel.

One call runs the state-passing form as three device kernels, each
parallel over the chunks: the chunk states (with the running log-decay
sums, in double), the carry of the state across the chunks, and the
outputs.  B and C in fp32 take the CUDA cores, in bf16 the tensor cores.
The wrapper allocates the output and the scratch the kernels share (the
running sums and the states, which ``ref.ssd_chunk_states`` and
``ref.ssd_state_pass`` compute, and each chunk's decay), checks its operands and raises on what the kernel does not
take, launches on the current stream, raises if the launch reports an
error, and counts its calls in ``ssd_scan.launches``: one a call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

MAX_P = MAX_N = 64
MAX_CHUNK = 256
TILE = 64             # positions a tile: kT in csrc/ssd_kernels.cu


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int, out_dtype: torch.dtype,
             intermediates: bool = False):
    """xdt (b, L, H, P) fp32, a (b, L, H) fp32, B/C (b, L, H, N) fp32 or
    bf16 (one dtype), P and N at most 64, 1 <= chunk <= 256 -> y (b, L, H,
    P) in ``out_dtype`` (fp32 or bf16), without the D term.  With
    ``intermediates`` -> (y, acum, h_prev): the running log-decay sums of
    each chunk, (b, H, chunks, chunk rounded up to 64) float64, and the
    state before each chunk, (b, H, chunks, 64, 64) fp32 padded from
    (N, P) with zeros, as the kernels left them in device memory."""
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
    n_chunks = -(-L // chunk)
    q_pad = -(-chunk // TILE) * TILE
    y = torch.empty((b, L, H, P), dtype=out_dtype, device=xdt.device)
    acum = torch.empty((b, H, n_chunks, q_pad), dtype=torch.float64,
                       device=xdt.device)
    state = torch.empty((b, H, n_chunks, MAX_N, MAX_P), dtype=torch.float32,
                        device=xdt.device)
    decay = torch.empty((b, H, n_chunks), dtype=torch.float32,
                        device=xdt.device)
    if y.numel():
        build.launch("fedadc_ssd_scan", xdt.data_ptr(), a.data_ptr(),
                     B.data_ptr(), C.data_ptr(), y.data_ptr(),
                     acum.data_ptr(), state.data_ptr(), decay.data_ptr(), b, L,
                     H, P, N, chunk,
                     DTYPE_CODE[B.dtype], DTYPE_CODE[out_dtype], stream())
        ssd_scan.launches += 1
    return (y, acum, state) if intermediates else y


ssd_scan.launches = 0
