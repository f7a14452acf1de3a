"""Model FLOPs of a round, the numerator of ``mfu``.

* A language model: 6·N·D, N the parameters, D the tokens a round trains
  on, ×4/3 under distillation (the teacher's extra forward).  Copied from
  ``src/repro_torch/launch/roofline.py`` (``model_flops_per_round``) at
  commit 9a9f55b; recomputation under remat is not counted.
* A convolutional network: 3 × 2·MACs of one image's forward pass, counted
  from the convolution and linear shapes (output positions × kh·kw·c_in·
  c_out), times the images a round trains on.  Normalisation, activations
  and pooling are not counted.
"""
from __future__ import annotations

from typing import Sequence, Tuple

# ResNet-18's stages as the port builds them (CIFAR stem: 3x3, no max-pool)
RESNET18_STAGES: Sequence[Tuple[int, int]] = ((64, 1), (128, 2), (256, 2),
                                              (512, 2))


def lm_train_flops(n_params: int, tokens: int, distill: bool = False) -> float:
    f = 6.0 * n_params * tokens
    return f * 4.0 / 3.0 if distill else f


def _out(size: int, stride: int) -> int:
    return -(-size // stride)          # "SAME" padding: ceil(size / stride)


def resnet18_forward_macs(image_size: int, n_classes: int,
                          stages=RESNET18_STAGES, blocks: int = 2) -> int:
    """Multiply-adds of one image through the CIFAR ResNet-18."""
    s = image_size
    macs = s * s * 3 * 3 * 3 * stages[0][0]                 # stem
    cin = stages[0][0]
    for cout, stride in stages:
        for b in range(blocks):
            st = stride if b == 0 else 1
            so = _out(s, st)
            macs += so * so * 9 * cin * cout                 # conv1
            macs += so * so * 9 * cout * cout                # conv2
            if st != 1 or cin != cout:
                macs += so * so * cin * cout                 # 1x1 proj
            s, cin = so, cout
    return macs + cin * n_classes                            # head


def conv_train_flops(forward_macs: int, images: int) -> float:
    return 3.0 * 2.0 * forward_macs * images
