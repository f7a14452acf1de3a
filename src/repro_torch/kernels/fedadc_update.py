"""Fused FedADC update kernels on the card (CUDA C++ in
``csrc/fedadc_kernels.cu``).

Counterparts of the Pallas kernels in the JAX package's
``kernels/fedadc_update.py``: ``fused_axpy`` (``fused_axpy_2d``),
``local_update`` (``local_update_2d``) and ``server_update``
(``server_update_2d``).  Each takes contiguous CUDA tensors of any shape —
one leaf, or one leaf stacked over the round's clients — and treats them as
flat buffers; the TPU's (rows, 128) lane tiling has no counterpart here.

Every wrapper checks its operands and raises on what the kernel does not
take, allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and counts its launches in
a plain integer attribute (``fused_axpy.launches``) so a run can show that
it went through the kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def check_operands(name: str, *tensors, dtype=None, shape=None,
                   device=None) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor with the given
    shape, dtype and device index (by default those of the first), in a
    dtype the kernel takes."""
    first = tensors[0]
    shape = first.shape if shape is None else shape
    dtype = first.dtype if dtype is None else dtype
    device = first.get_device() if device is None else device
    if dtype not in DTYPE_CODE:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32, bfloat16)")
    for t in tensors:
        if not t.is_cuda:
            raise ValueError(f"{name}: needs CUDA tensors, got {t.device}")
        if t.get_device() != device:
            raise ValueError(f"{name}: operands on cuda:{device} and "
                             f"{t.device}")
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} where "
                             f"{dtype} {tuple(shape)} is needed")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def fused_axpy(x: torch.Tensor, y: torch.Tensor, a: float) -> torch.Tensor:
    """x + a·y."""
    check_operands("fused_axpy", x, y)
    out = torch.empty_like(x)
    if x.numel():
        build.launch("fedadc_fused_axpy", x.data_ptr(), y.data_ptr(),
                     out.data_ptr(), x.numel(), a, DTYPE_CODE[x.dtype],
                     stream())
        fused_axpy.launches += 1
    return out


def local_update(theta: torch.Tensor, g: torch.Tensor, m_bar: torch.Tensor,
                 eta: float) -> torch.Tensor:
    """θ − η·(g + m̄), the FedADC heavy-ball local step."""
    check_operands("local_update", theta, g, m_bar)
    out = torch.empty_like(theta)
    if theta.numel():
        build.launch("fedadc_local_update", theta.data_ptr(), g.data_ptr(),
                     m_bar.data_ptr(), out.data_ptr(), theta.numel(), eta,
                     DTYPE_CODE[theta.dtype], stream())
        local_update.launches += 1
    return out


def server_update(theta: torch.Tensor, m: torch.Tensor,
                  delta_bar: torch.Tensor, gamma: float, alpha_eta: float):
    """m' = Δ̄ + γ·m ; θ' = θ − αη·m'  -> (θ', m').  ``m`` and ``delta_bar``
    are fp32 whatever θ's dtype; θ' is rounded to θ's dtype on write."""
    check_operands("server_update", theta)
    check_operands("server_update", m, delta_bar, dtype=torch.float32,
                   shape=theta.shape, device=theta.get_device())
    theta_out = torch.empty_like(theta)
    m_out = torch.empty_like(m)
    if theta.numel():
        build.launch("fedadc_server_update", theta.data_ptr(), m.data_ptr(),
                     delta_bar.data_ptr(), theta_out.data_ptr(),
                     m_out.data_ptr(), theta.numel(), gamma, alpha_eta,
                     DTYPE_CODE[theta.dtype], stream())
        server_update.launches += 1
    return theta_out, m_out


fused_axpy.launches = 0
local_update.launches = 0
server_update.launches = 0
