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

Any head dim D (``plan``): bf16 up to 256 on the tensor cores in the
template at or above it (32, 64, 80, 96, 128, 192, 256), fp32 up to 128 on
the CUDA cores (64 or 128), and beyond either a simple CUDA-core kernel
that sums Q·Kᵀ over the whole D and writes V's columns in slices of 256, a
launch a slice.  A D that is no multiple of 8 is padded with zero columns
(the TMA's rows need 16 bytes), which change no score.

The wrapper checks its operands and raises on what the kernel does not
take, copies an operand whose start is not 16-byte aligned (the kernels
copy 16 bytes at a time), allocates the output with ``torch.empty``,
launches on the current stream, raises if the launch reports an error, and
counts its launches in ``flash_attention.launches``: ``plan``'s launches a
call.  There is no backward:
``ops.flash_attention`` refuses operands that need a gradient.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream

# the bf16 route's templates (its depth of Q·Kᵀ, in k16 steps): a head dim
# takes the smallest at or above it, the TMA filling the columns past it
# with zeros
TC_TEMPLATES = (32, 64, 80, 96, 128, 192, 256)
F32_TEMPLATES = (64, 128)   # the fp32 route's, padded in shared memory
WIDE_SLICE = 256            # V's columns a launch of the wide route writes


def plan(D: int, dtype) -> dict:
    """The kernels' plan for head dim ``D`` in ``dtype`` (fp32 or bf16), a
    pure function of the two: the head dim the kernels see (``d_pad``, D
    rounded up to 8; the wrapper pads the operands with zero columns where
    it differs), the route ("tc": bf16 up to 256 on the tensor cores; "f32":
    fp32 up to 128 on the CUDA cores; "wide": beyond, the CUDA cores, both
    dtypes), the template (the tc route's depth, the f32 route's padded
    width; the wide route's column slices' widths rounded up to 64), and the
    slices of V's columns, (v0, width), one launch each, tiling [0, d_pad)
    with no gap or overlap."""
    if D < 1:
        raise ValueError(f"flash_attention: head dim {D} must be at least 1")
    d_pad = -(-D // 8) * 8
    bf16 = dtype == torch.bfloat16
    if bf16 and d_pad <= TC_TEMPLATES[-1]:
        route = "tc"
        template = next(t for t in TC_TEMPLATES if t >= d_pad)
    elif not bf16 and d_pad <= F32_TEMPLATES[-1]:
        route = "f32"
        template = next(t for t in F32_TEMPLATES if t >= d_pad)
    else:
        route, template = "wide", None
    slices = ([(v0, min(WIDE_SLICE, d_pad - v0))
               for v0 in range(0, d_pad, WIDE_SLICE)] if route == "wide"
              else [(0, d_pad)])
    if route == "wide":
        template = tuple(-(-w // 64) * 64 for _, w in slices)
    return {"d_pad": d_pad, "route": route, "template": template,
            "slices": slices, "launches": len(slices)}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    return t if t.data_ptr() % 16 == 0 else t.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B, L, H, D), k/v (B, L, Hk, D), one dtype (fp32 or bf16), any D,
    H a multiple of Hk -> (B, L, H, D) in q's dtype, scaled by D**-0.5 of
    the true D (``plan`` says which kernel and how many launches)."""
    check_operands("flash_attention", q)
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, L, H, D)")
    B, L, H, D = q.shape
    Hk = k.shape[2]
    if Hk == 0 or H % Hk:
        raise ValueError(f"flash_attention: {H} heads do not share {Hk} kv "
                         f"heads evenly")
    check_operands("flash_attention", k, v, dtype=q.dtype, shape=(B, L, Hk, D),
                   device=q.get_device())
    pl = plan(D, q.dtype)
    if q.numel() == 0:
        return torch.empty_like(q)
    d_pad = pl["d_pad"]
    if d_pad != D:   # zero columns change no score and are dropped below
        q, k, v = (torch.nn.functional.pad(t, (0, d_pad - D))
                   for t in (q, k, v))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    o = torch.empty_like(q)
    for v0, _ in pl["slices"]:
        build.launch("fedadc_flash_attention", q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), B, L, H, Hk, d_pad, v0,
                     int(causal), int(window), D ** -0.5,
                     DTYPE_CODE[q.dtype], stream())
        flash_attention.launches += 1
    return o if d_pad == D else o[..., :D].contiguous()


flash_attention.launches = 0
