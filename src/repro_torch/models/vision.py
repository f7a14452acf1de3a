"""The paper's own experiment models (counterparts of the JAX package's
``models/vision.py``).

* ``cnn``   — 4 conv + 4 FC, no batch norm, maxpool (Sec. IV-B1, CIFAR-10).
* ``resnet18`` — ResNet-18 with GroupNorm(32) after convs (Sec. IV-C1,
  CIFAR-100).

The public functions take NHWC images, as the reference does.  Inside,
activations are NCHW for ``F.conv2d`` and conv weights are OIHW
(``repro_torch.convert`` carries JAX's HWIO weights across).  Two layout
facts are kept from the reference: XLA's "SAME" padding, which at stride 2
on an even input pads only bottom/right, and the NHWC flatten before
``f1``, whose rows are in (H, W, C) order.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.core.tree import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def he_linear_init(gen, d_in, d_out, dtype=torch.float32):
    """Kaiming-normal init for ReLU stacks, ``w`` stored (d_in, d_out)."""
    w = torch.randn((d_in, d_out), generator=gen) * math.sqrt(2.0 / d_in)
    return {"w": w.to(dtype), "b": torch.zeros((d_out,), dtype=dtype)}


def conv_init(gen, kh, kw, cin, cout, dtype=torch.float32):
    fan_in = kh * kw * cin
    w = torch.randn((cout, cin, kh, kw), generator=gen) * math.sqrt(2.0 / fan_in)
    return {"w": w.to(dtype), "b": torch.zeros((cout,), dtype=dtype)}


def same_pads(size: int, k: int, stride: int):
    """XLA "SAME" padding of one spatial dim -> (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(p, x, stride=1):
    """SAME-padded conv of NCHW activations with OIHW weights, plus bias."""
    w = p["w"].to(x.dtype)
    (top, bottom) = same_pads(x.shape[-2], w.shape[-2], stride)
    (left, right) = same_pads(x.shape[-1], w.shape[-1], stride)
    if top == bottom and left == right:
        y = F.conv2d(x, w, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)
    return y + p["b"].to(x.dtype).reshape(1, -1, 1, 1)


def maxpool(x, k=2):
    return F.max_pool2d(x, k, k)


def _on_device(params, device):
    dev = resolve_device(device)
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# Paper CNN: 4 conv + 4 FC.
# ---------------------------------------------------------------------------
def cnn_init(seed: int, n_classes=10, dtype=torch.float32, width=32,
             image_size=32, device=None):
    """Random weights from ``seed`` (drawn on the CPU, so every device gets
    the same ones), placed on ``device`` (the card when None)."""
    gen = torch.Generator().manual_seed(seed)
    w = width
    spatial = max(image_size // 16, 1) ** 2   # after 4 maxpools
    params = {
        "c1": conv_init(gen, 3, 3, 3, w, dtype),
        "c2": conv_init(gen, 3, 3, w, 2 * w, dtype),
        "c3": conv_init(gen, 3, 3, 2 * w, 4 * w, dtype),
        "c4": conv_init(gen, 3, 3, 4 * w, 4 * w, dtype),
        "f1": he_linear_init(gen, 4 * w * spatial, 512, dtype=dtype),
        "f2": he_linear_init(gen, 512, 256, dtype=dtype),
        "f3": he_linear_init(gen, 256, 128, dtype=dtype),
        "head": he_linear_init(gen, 128, n_classes, dtype=dtype),
    }
    return _on_device(params, device)


def cnn_features(params, x):
    """x (B,32,32,3) NHWC -> penultimate features (B,128)."""
    x = x.permute(0, 3, 1, 2)
    x = maxpool(F.relu(conv(params["c1"], x)))          # 16
    x = maxpool(F.relu(conv(params["c2"], x)))          # 8
    x = maxpool(F.relu(conv(params["c3"], x)))          # 4
    x = maxpool(F.relu(conv(params["c4"], x)))          # 2
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # NHWC flatten
    x = F.relu(L.linear(params["f1"], x))
    x = F.relu(L.linear(params["f2"], x))
    x = F.relu(L.linear(params["f3"], x))
    return x


def cnn_apply(params, x):
    return L.linear(params["head"], cnn_features(params, x))


# ---------------------------------------------------------------------------
# ResNet-18 (GroupNorm).
# ---------------------------------------------------------------------------
def _basic_block_init(gen, cin, cout, stride, dtype):
    p = {"conv1": conv_init(gen, 3, 3, cin, cout, dtype),
         "gn1": L.groupnorm_init(cout, dtype),
         "conv2": conv_init(gen, 3, 3, cout, cout, dtype),
         "gn2": L.groupnorm_init(cout, dtype)}
    if stride != 1 or cin != cout:
        p["proj"] = conv_init(gen, 1, 1, cin, cout, dtype)
    return p


def _basic_block(p, x, stride):
    y = F.relu(L.groupnorm(p["gn1"], conv(p["conv1"], x, stride)))
    y = L.groupnorm(p["gn2"], conv(p["conv2"], y))
    sc = conv(p["proj"], x, stride) if "proj" in p else x
    return F.relu(y + sc)


RESNET18_STAGES = [(64, 1), (128, 2), (256, 2), (512, 2)]


def resnet18_init(seed: int, n_classes=100, dtype=torch.float32,
                  device=None):
    gen = torch.Generator().manual_seed(seed)
    p: Dict = {"stem": conv_init(gen, 3, 3, 3, 64, dtype),
               "gn0": L.groupnorm_init(64, dtype)}
    cin = 64
    for si, (cout, stride) in enumerate(RESNET18_STAGES):
        for bi in range(2):
            st = stride if bi == 0 else 1
            p[f"s{si}b{bi}"] = _basic_block_init(gen, cin, cout, st, dtype)
            cin = cout
    p["head"] = he_linear_init(gen, 512, n_classes, dtype=dtype)
    return _on_device(p, device)


def resnet18_features(params, x):
    """x (B,H,W,3) NHWC -> global-average-pooled features (B,512)."""
    x = x.permute(0, 3, 1, 2)
    x = F.relu(L.groupnorm(params["gn0"], conv(params["stem"], x)))
    for si, (cout, stride) in enumerate(RESNET18_STAGES):
        for bi in range(2):
            st = stride if bi == 0 else 1
            x = _basic_block(params[f"s{si}b{bi}"], x, st)
    return x.mean(dim=(2, 3))                              # GAP (B,512)


def resnet18_apply(params, x):
    return L.linear(params["head"], resnet18_features(params, x))


# ---------------------------------------------------------------------------
# Uniform interface used by the federated simulator.
# ---------------------------------------------------------------------------
VISION_MODELS = {
    "cnn": (cnn_init, cnn_apply, cnn_features, "head"),
    "resnet18": (resnet18_init, resnet18_apply, resnet18_features, "head"),
}
