"""The least bytes and operations of the port's sweep kernels, for
``kernels_roofline``.

Each formula counts every input element read once and every output
element written once, as the algorithm needs them, whatever the kernel
re-reads.  The operands follow ``src/repro_torch/kernels/ref.py`` at
commit 9a9f55b:

* ``fused_axpy``: out = x + a·y (x, y, out in one dtype);
* ``server_update``: Δ̄ = s·Δ; m' = Δ̄ + γ·m; θ' = θ − αη·m' (θ in the
  parameter dtype, m and Δ in fp32; writes θ' and m');
* ``weighted_reduce``: out = Σ_k w_k·Δ_k / Σ_k w_k over K rows (out fp32).

A family is recognised in a profiler trace by the names of its
``__global__`` functions in ``src/repro_torch/csrc/fedadc_kernels.cu``.
"""
from __future__ import annotations

from typing import Dict, Optional

FAMILIES: Dict[str, tuple] = {
    "fused_axpy": ("axpy_leaves_kernel",),
    "server_update": ("server_update_leaves_kernel",),
    "weighted_reduce": ("reduce_leaves_kernel",),
}


def plain_fedadc(fed: Dict) -> bool:
    """True for the rounds whose sweeps the engines list: FedADC's
    nesterov variant with the plain wire both ways."""
    return (fed.get("strategy") == "fedadc"
            and fed.get("variant") == "nesterov"
            and fed.get("compressor", "none") == "none"
            and fed.get("downlink_compressor", "none") == "none")


def family_of(kernel_name: str) -> Optional[str]:
    for family, words in FAMILIES.items():
        if any(w in kernel_name for w in words):
            return family
    return None


def fused_axpy(elements: int, itemsize: int):
    return {"bytes": 3 * itemsize * elements, "flops": 2 * elements}


def server_update(elements: int, theta_itemsize: int):
    return {"bytes": (2 * theta_itemsize + 3 * 4) * elements,
            "flops": 6 * elements}


def weighted_reduce(elements: int, rows: int, itemsize: int):
    return {"bytes": (rows * itemsize + 4) * elements,
            "flops": 2 * rows * elements}


def sweep(family: str, count: int, **operands) -> Dict:
    """``count`` sweeps of ``family`` a round -> {"family", "count",
    "bytes", "flops"}, the last two for one sweep."""
    cost = {"fused_axpy": fused_axpy, "server_update": server_update,
            "weighted_reduce": weighted_reduce}[family](**operands)
    return {"family": family, "count": count, **cost}
