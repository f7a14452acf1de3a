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
outputs.  Any P, N and chunk (``plan``): 64-wide slices of P and of N on
the states' grid, of P on the outputs'; the outputs take N up to 128 in one
pass and above that in passes of 128 that add into an fp32 partial of y;
a chunk above 256 runs its running sums as a fourth kernel first.  B and C in fp32 take the CUDA cores, in bf16 the tensor cores.
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

TILE = 64             # positions a tile, and a slice of N or P: kT in
                      # csrc/ssd_kernels.cu
MAX_Q = 256           # kMaxQ: a chunk whose running sums one block holds
MAX_NT = 128          # kMaxNT: columns of N an outputs pass takes


def _up(n: int, m: int) -> int:
    return -(-n // m) * m


def plan(b: int, L: int, H: int, P: int, N: int, chunk: int) -> dict:
    """The kernels' plan for a call, as ``fedadc_ssd_scan`` in the .cu
    makes it, from the shapes alone: the chunks and the padded chunk
    (``q_pad``), the state's padded (``n_pad``, ``p_pad``), the 64-wide
    slices of N and P (``n_slices``, ``p_slices``: (start, width), tiling
    each axis with no gap or overlap), the outputs' passes over N
    (``passes``: (n0, width, template) with width <= MAX_NT, the template 64
    or 128 columns), whether a chunk above MAX_Q takes the sums kernel
    (``long_chunk``), each kernel's grid (``grids``), the fp32 partial of y
    that several passes share (``part``: its elements, else 0) and the
    wrapper's launches (one a call).  Raises ValueError on a shape no
    kernel takes: a dimension below 1, or a grid past the int32 bound."""
    if min(b, L, H, P, N, chunk) < 1:
        raise ValueError(f"ssd_scan: (b, L, H, P, N, chunk) {(b, L, H, P, N, chunk)} "
                         f"must all be at least 1")
    n_chunks = -(-L // chunk)
    q_pad = _up(chunk, TILE)
    n_pad, p_pad = _up(N, TILE), _up(P, TILE)
    n_slices = [(n0, min(TILE, N - n0)) for n0 in range(0, N, TILE)]
    p_slices = [(p0, min(TILE, P - p0)) for p0 in range(0, P, TILE)]
    passes = []
    for n0 in range(0, N, MAX_NT):
        width = min(MAX_NT, N - n0)
        passes.append((n0, width, TILE if width <= TILE else MAX_NT))
    chunks = b * H * n_chunks
    grids = {"sums": chunks if chunk > MAX_Q else 0,
             "states": chunks * len(n_slices) * len(p_slices),
             "carry": b * H * n_pad * p_pad // (4 * 128),
             "outputs": chunks * len(p_slices) * (q_pad // TILE)}
    if max(grids.values()) >= 2 ** 31 or n_pad * p_pad >= 2 ** 31:
        raise ValueError(f"ssd_scan: a grid of {max(grids.values())} blocks "
                         f"reaches the int32 bound")
    return {"n_chunks": n_chunks, "q_pad": q_pad, "n_pad": n_pad,
            "p_pad": p_pad, "n_slices": n_slices, "p_slices": p_slices,
            "passes": passes, "long_chunk": chunk > MAX_Q, "grids": grids,
            "part": b * L * H * P if len(passes) > 1 else 0, "launches": 1}


def ssd_scan(xdt: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, chunk: int, out_dtype: torch.dtype,
             intermediates: bool = False):
    """xdt (b, L, H, P) fp32, a (b, L, H) fp32, B/C (b, L, H, N) fp32 or
    bf16 (one dtype), any P, N and chunk >= 1 (``plan``) -> y (b, L, H, P)
    in ``out_dtype`` (fp32 or bf16), without the D term.  With
    ``intermediates`` -> (y, acum, h_prev): the running log-decay sums of
    each chunk, (b, H, chunks, chunk rounded up to 64) float64, and the
    state before each chunk, (b, H, chunks, N rounded up to 64, P rounded
    up to 64) fp32 padded from (N, P) with zeros, as the kernels left them
    in device memory."""
    check_operands("ssd_scan", xdt, dtype=torch.float32)
    if xdt.dim() != 4:
        raise ValueError("ssd_scan: x must be (b, L, H, P)")
    b, L, H, P = xdt.shape
    N = B.shape[-1]
    pl = plan(b, L, H, P, N, chunk)
    dev = xdt.get_device()
    check_operands("ssd_scan", a, dtype=torch.float32, shape=(b, L, H),
                   device=dev)
    check_operands("ssd_scan", B, C, shape=(b, L, H, N), device=dev)
    if out_dtype not in DTYPE_CODE:
        raise ValueError(f"ssd_scan: output dtype {out_dtype} not supported")
    n_chunks = pl["n_chunks"]
    y = torch.empty((b, L, H, P), dtype=out_dtype, device=xdt.device)
    acum = torch.empty((b, H, n_chunks, pl["q_pad"]), dtype=torch.float64,
                       device=xdt.device)
    state = torch.empty((b, H, n_chunks, pl["n_pad"], pl["p_pad"]),
                        dtype=torch.float32, device=xdt.device)
    decay = torch.empty((b, H, n_chunks), dtype=torch.float32,
                        device=xdt.device)
    part = (torch.empty(pl["part"], dtype=torch.float32, device=xdt.device)
            if pl["part"] else None)
    if y.numel():
        build.launch("fedadc_ssd_scan", xdt.data_ptr(), a.data_ptr(),
                     B.data_ptr(), C.data_ptr(), y.data_ptr(),
                     acum.data_ptr(), state.data_ptr(), decay.data_ptr(),
                     part.data_ptr() if part is not None else None, b, L,
                     H, P, N, chunk,
                     DTYPE_CODE[B.dtype], DTYPE_CODE[out_dtype], stream())
        ssd_scan.launches += 1
    return (y, acum, state) if intermediates else y


ssd_scan.launches = 0
