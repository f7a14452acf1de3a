"""Delta-compression kernels on the card (CUDA C++ in
``csrc/compress_kernels.cu``), the counterparts of the Pallas kernels in the
JAX package's ``kernels/compress.py``: ``threshold_select``
(``threshold_select_2d``) and ``qsgd`` (``qsgd_2d``).

Each emits the reconstruction q AND the residual v − q from one pass over
the input.  Both take one leaf stacked over the round's clients, (B, ...),
with one scalar per client row — the top-k threshold τ or the QSGD scale —
so a stacked leaf is one launch, not B.  The scalars are computed outside
the kernel (``torch.topk``, ``amax``), as ``lax.top_k`` and ``jnp.max`` are
in the reference.

Every wrapper checks its operands and raises on what the kernel does not
take, allocates its outputs with ``torch.empty``, launches on the current
stream, raises if the launch reports an error, and counts its launches in a
plain integer attribute.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fedadc_update import DTYPE_CODE, check_operands, stream


def _row_scalars(name, v, scalars):
    """Check the per-row scalars -> (rows, elements per row)."""
    if v.dim() == 0:
        raise ValueError(f"{name}: needs a leaf stacked over clients (B, ...)")
    rows = v.shape[0]
    check_operands(name, scalars, dtype=v.dtype, shape=(rows,),
                   device=v.get_device())
    return rows, v.numel() // rows if rows else 0


def threshold_select(v: torch.Tensor, thresh: torch.Tensor):
    """q = v·1[|v| ≥ τ_row], r = v − q for v (B, ...) and τ (B,) in v's
    dtype -> (q, r)."""
    check_operands("threshold_select", v)
    rows, n = _row_scalars("threshold_select", v, thresh)
    q, r = torch.empty_like(v), torch.empty_like(v)
    if v.numel():
        build.launch("fedadc_threshold_select", v.data_ptr(), thresh.data_ptr(),
                     q.data_ptr(), r.data_ptr(), rows, n,
                     DTYPE_CODE[v.dtype], stream())
        threshold_select.launches += 1
    return q, r


def qsgd(v: torch.Tensor, u: torch.Tensor, scale: torch.Tensor, s: int):
    """QSGD quantise-dequantise of v (B, ...) with the uniform draw u (v's
    shape and dtype), the per-row scale (B,) in v's dtype and ``s`` levels
    -> (q, r)."""
    check_operands("qsgd", v, u)
    rows, n = _row_scalars("qsgd", v, scale)
    q, r = torch.empty_like(v), torch.empty_like(v)
    if v.numel():
        build.launch("fedadc_qsgd", v.data_ptr(), u.data_ptr(),
                     scale.data_ptr(), q.data_ptr(), r.data_ptr(), rows, n,
                     float(s), DTYPE_CODE[v.dtype], stream())
        qsgd.launches += 1
    return q, r


threshold_select.launches = 0
qsgd.launches = 0
