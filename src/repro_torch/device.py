"""Where the port runs: on the card unless the caller asks for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Without one this raises instead of falling
    back to the CPU; pass ``device="cpu"`` to run there on purpose."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; the port runs "
                               "on the GPU unless given device='cpu'")
        return torch.device("cuda")
    return torch.device(device)
