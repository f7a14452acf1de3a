"""Which device kernels are matrix products, by their names.

Copied from ``chip_smoke.py`` at commit 9a9f55b (``GEMM_WORDS``,
``TENSOR_CORE_WORDS``, ``gemm_class``), unchanged: cuBLAS, cuBLASLt's
nvjet, CUTLASS and cuDNN's implicit-GEMM convolutions all carry one of the
words.
"""
from __future__ import annotations

# words of a GEMM kernel's name (cuBLAS, cuBLASLt's nvjet, CUTLASS)
GEMM_WORDS = ("gemm", "gemv", "nvjet", "xmma", "cutlass")
# words of one that runs on the tensor cores (bf16/fp16, TF32)
TENSOR_CORE_WORDS = ("nvjet", "bf16", "f16", "tf32", "s16816", "tensorop",
                     "hmma", "wgmma")


def gemm_class(name):
    """"tensor cores" or "cuda cores" for a GEMM kernel's name (fp32
    without TF32, PyTorch's default for matmul, runs on the CUDA cores),
    None for any other kernel."""
    n = name.lower()
    if not any(w in n for w in GEMM_WORDS):
        return None
    return "tensor cores" if any(w in n for w in TENSOR_CORE_WORDS) \
        else "cuda cores"
