"""Published peaks of the card, by the name ``torch.cuda.get_device_name``
gives.

Copied from ``src/repro_torch/launch/roofline.py`` at commit 9a9f55b
(``H100_SXM``, ``H100_NVL``, ``H100_PCIE``, ``peaks_for``): NVIDIA's data
sheets, dense rates without sparsity.  TF32 is added here at half the
bf16 rate, as the same sheets give it.  A card of another name takes the
SXM5 figures and says so in ``name``.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Peaks:
    name: str
    bf16: float      # FLOP/s, tensor cores, bf16 / fp16 operands
    tf32: float      # FLOP/s, tensor cores, TF32
    fp32: float      # FLOP/s, CUDA cores
    hbm: float       # bytes/s

    def flops(self, kind: str) -> float:
        return {"bf16": self.bf16, "tf32": self.tf32, "fp32": self.fp32}[kind]


H100_SXM = Peaks("H100 SXM5 (spec sheet)", 989e12, 494.5e12, 67e12, 3.35e12)
H100_NVL = Peaks("H100 NVL (spec sheet)", 835e12, 417.5e12, 60e12, 3.9e12)
H100_PCIE = Peaks("H100 PCIe (spec sheet)", 756e12, 378e12, 51e12, 2.0e12)


def peaks_for(card_name: str) -> Peaks:
    n = card_name.upper()
    if "H100" in n and "NVL" in n:
        return H100_NVL
    if "H100" in n and "PCIE" in n:
        return H100_PCIE
    if "H100" in n:
        return H100_SXM
    return dataclasses.replace(
        H100_SXM, name=f"H100 SXM5 (spec sheet; card {card_name!r} unknown)")
