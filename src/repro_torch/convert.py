"""Carry parameters across between the JAX package and the port.

The JAX package keeps parameters as nested dicts of arrays; the port keeps
the same key paths with tensors.  Layouts:

* the vision models' conv ``w``: HWIO in JAX (``lax.conv_general_dilated``
  with NHWC/HWIO) and OIHW here (``F.conv2d``).  A leaf is such a weight
  when it is 4-d, named ``w``, and its layer is one of the vision models'
  convolutions (``c1``..``c4``, ``stem``, ``conv1``/``conv2``, ``proj``) or
  a bare conv layer ``{"w", "b"}``; no LM leaf is ever permuted;
* linear ``w``: ``(d_in, d_out)`` on both sides (``x @ w + b``), unchanged;
* every other leaf is unchanged: biases and norms, and the LM trees as
  they are — nested ``runs`` dicts whose leaves carry a leading layer axis,
  the Mamba2 and mLSTM ``conv_w`` (d_conv, channels), ``A_log``, ``D``,
  ``dt_bias``, the MoE experts' 4-d ``gate``/``up``/``down``, the sLSTM's
  ``r``, ``vis_proj``, the encoder-decoder's ``enc``/``dec`` and the tied
  embedding.

Both directions go through numpy, so neither package imports the other.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.core.tree import tree_map_with_path


VISION_CONV = re.compile(r"c\d+|stem|conv\d+|proj")


def _is_conv(path, a) -> bool:
    return (path[-1] == "w" and np.ndim(a) == 4
            and (len(path) == 1 or VISION_CONV.fullmatch(path[-2]) is not None))


def from_numpy(params, device, dtype=None):
    """Nested dict of numpy arrays in the JAX layout -> dict of tensors in
    the port's layout on ``device``."""
    def leaf(path, a):
        a = np.asarray(a)
        if _is_conv(path, a):
            a = a.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)
    return tree_map_with_path(leaf, params)


def to_numpy(params):
    """Dict of tensors in the port's layout -> nested dict of numpy arrays
    in the JAX layout."""
    def leaf(path, t):
        a = t.detach().cpu()
        if a.dtype == torch.bfloat16:
            a = a.float()
        a = a.numpy()
        if _is_conv(path, a):
            a = a.transpose(2, 3, 1, 0)              # OIHW -> HWIO
        return np.ascontiguousarray(a)
    return tree_map_with_path(leaf, params)
