"""Plain reference of ResNet-18 for 32x32 images as the port's
configuration defines it, and the benchmark's own weights for it.

ResNet-18 (He et al., arXiv:1512.03385) in its CIFAR form: a 3x3 stem of
64 channels and no max-pool, four stages of two basic blocks (64, 128,
256, 512 channels; the first block of stages 2-4 strides 2 and has a 1x1
projection shortcut), global average pooling and a linear head.  Each
convolution has a bias and "SAME" padding as XLA pads it (at stride 2 on
an even size only the bottom and right are padded).  Normalisation
follows group norm (Hsieh et al., arXiv:1910.00189) after every
convolution of the stem and the blocks, with per-channel scale and bias.

Departure, as the port's configuration has it: the normalisation's mean
and variance span every channel and position of a sample (one group in
effect, a layer norm over C, H, W), not 32 groups.

Plain PyTorch; imports nothing of the program.  Parameters are a flat
dict ``{"a/b/c": tensor}`` with the port's paths and shapes
(convolutions O, I, kh, kw; the head's ``w`` (512, classes)).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

STAGES = ((64, 1), (128, 2), (256, 2), (512, 2))


def layout(cfg) -> Dict[str, Tuple[tuple, str, float]]:
    """path -> (shape, init, scale): He-normal convolutions and head (std
    √(2/fan_in)), zero biases, unit norm scales, zero norm biases."""
    out = {}

    def conv(name, k, cin, cout):
        out[f"{name}/w"] = ((cout, cin, k, k), "normal",
                            math.sqrt(2.0 / (k * k * cin)))
        out[f"{name}/b"] = ((cout,), "const", 0.0)

    def norm(name, c):
        out[f"{name}/scale"] = ((c,), "const", 1.0)
        out[f"{name}/bias"] = ((c,), "const", 0.0)
    conv("stem", 3, 3, STAGES[0][0])
    norm("gn0", STAGES[0][0])
    cin = STAGES[0][0]
    for si, (cout, stride) in enumerate(STAGES):
        for bi in range(2):
            st = stride if bi == 0 else 1
            b = f"s{si}b{bi}"
            conv(f"{b}/conv1", 3, cin, cout)
            norm(f"{b}/gn1", cout)
            conv(f"{b}/conv2", 3, cout, cout)
            norm(f"{b}/gn2", cout)
            if st != 1 or cin != cout:
                conv(f"{b}/proj", 1, cin, cout)
            cin = cout
    out["head/w"] = ((cin, cfg["n_classes"]), "normal", math.sqrt(2.0 / cin))
    out["head/b"] = ((cfg["n_classes"],), "const", 0.0)
    return out


def make_params(cfg, seed: int, device):
    """The benchmark's weights from ``seed`` on ``device``: every random
    leaf a scaled view of one normal draw."""
    lay = layout(cfg)
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    n = sum(math.prod(s) for s, k, _ in lay.values() if k == "normal")
    buf = torch.empty(n, dtype=torch.float32, device=device)
    buf.normal_(0.0, 1.0, generator=gen)
    out, off = {}, 0
    for path, (shape, kind, scale) in lay.items():
        if kind == "normal":
            k = math.prod(shape)
            t = buf[off:off + k].view(shape).mul_(scale)
            off += k
        else:
            t = torch.full(shape, scale, dtype=torch.float32, device=device)
        out[path] = t
    return out


def _same(size, k, stride):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv(x, w, b, stride=1):
    top, bottom = _same(x.shape[-2], w.shape[-2], stride)
    left, right = _same(x.shape[-1], w.shape[-1], stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, w, stride=stride) + b.reshape(1, -1, 1, 1)


def norm(x, scale, bias, eps=1e-5):
    mu = x.mean(dim=(1, 2, 3), keepdim=True)
    var = ((x - mu) ** 2).mean(dim=(1, 2, 3), keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * scale.reshape(1, -1, 1, 1) + bias.reshape(1, -1, 1, 1)


def logits(p, images):
    """images (B, H, W, 3) -> (B, classes)."""
    x = images.permute(0, 3, 1, 2)
    x = F.relu(norm(conv(x, p["stem/w"], p["stem/b"]), p["gn0/scale"],
                    p["gn0/bias"]))
    for si, (_, stride) in enumerate(STAGES):
        for bi in range(2):
            st = stride if bi == 0 else 1
            b = f"s{si}b{bi}"
            y = F.relu(norm(conv(x, p[f"{b}/conv1/w"], p[f"{b}/conv1/b"], st),
                            p[f"{b}/gn1/scale"], p[f"{b}/gn1/bias"]))
            y = norm(conv(y, p[f"{b}/conv2/w"], p[f"{b}/conv2/b"]),
                     p[f"{b}/gn2/scale"], p[f"{b}/gn2/bias"])
            sc = conv(x, p[f"{b}/proj/w"], p[f"{b}/proj/b"], st) \
                if f"{b}/proj/w" in p else x
            x = F.relu(y + sc)
    return x.mean(dim=(2, 3)) @ p["head/w"] + p["head/b"]


def loss(params, batch, cfg):
    """Mean cross-entropy of the batch's images against their labels (the
    log-sum-exp in float32)."""
    z = logits(params, batch["images"].to(params["stem/w"].dtype)).float()
    gold = torch.gather(z, -1, batch["labels"].long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(z, dim=-1) - gold)
