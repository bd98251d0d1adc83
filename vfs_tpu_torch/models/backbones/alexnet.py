"""AlexNet V1-V3, the SiamFC backbones (counterpart of
``vfs_tpu/models/backbones/alexnet.py``; reference:
mmaction/models/backbones/alexnet.py:40-100).

NCHW in and out. Every convolution is unpadded with a bias; the
BatchNorms take eps 1e-6 and momentum 0.05 (flax 0.95), the reference's
``_BatchNorm2d``. Names: ``conv{n}`` and ``bn{n}``.
"""

from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..common.norm import BatchNorm2d
from ..registry import BACKBONES


def _bn(features):
    bn = BatchNorm2d(features, eps=1e-6)
    bn.flax_momentum = 0.95
    return bn


class _AlexNet(nn.Module):
    """Layers from a table of (out, kernel, stride, groups, bn, relu) and
    the two max pools' strides."""
    layers = ()
    pool_strides = (2, 2)

    def __init__(self):
        super().__init__()
        in_c = 3
        for n, (out, k, s, g, bn, _) in enumerate(self.layers, 1):
            self.add_module(f'conv{n}', nn.Conv2d(in_c, out, k, s, groups=g))
            if bn:
                self.add_module(f'bn{n}', _bn(out))
            in_c = out

    def forward(self, x):
        for n, (*_, bn, relu) in enumerate(self.layers, 1):
            x = getattr(self, f'conv{n}')(x)
            if bn:
                x = getattr(self, f'bn{n}')(x)
            if relu:
                x = F.relu(x)
            if n <= 2:
                x = F.max_pool2d(x, 3, self.pool_strides[n - 1])
        return x


@BACKBONES.register_module()
class AlexNetV1(_AlexNet):
    """Grouped AlexNet (SiamFC's original); conv5 is a bare conv."""
    layers = ((96, 11, 2, 1, True, True), (256, 5, 1, 2, True, True),
              (384, 3, 1, 1, True, True), (384, 3, 1, 2, True, True),
              (256, 3, 1, 2, False, False))


@BACKBONES.register_module()
class AlexNetV2(_AlexNet):
    """The second pool takes stride 1 (output stride 4)."""
    layers = ((96, 11, 2, 1, True, True), (256, 5, 1, 2, True, True),
              (384, 3, 1, 1, True, True), (384, 3, 1, 2, True, True),
              (32, 3, 1, 2, False, False))
    pool_strides = (2, 1)


@BACKBONES.register_module()
class AlexNetV3(_AlexNet):
    layers = ((192, 11, 2, 1, True, True), (512, 5, 1, 1, True, True),
              (768, 3, 1, 1, True, True), (768, 3, 1, 1, True, True),
              (512, 3, 1, 1, True, False))
