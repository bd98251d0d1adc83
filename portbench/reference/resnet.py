"""Plain ResNet (He et al. 2016) as VFS configures it, NCHW inside, with
torchvision's parameter names so that one seeded state dict loads into
the reference and the program alike.

- stem: 7x7/2 convolution, BatchNorm, ReLU, 3x3/2 max pool;
- stages of BasicBlocks (depth 18) or Bottlenecks (depth 50, the stride
  on the 3x3 convolution); a 1x1 convolution and BatchNorm on the
  shortcut where the shape changes; ``strides`` per stage; stages after
  the last of ``out_indices`` do not run;
- BatchNorm, eps 1e-5. In training mode it follows the configurations'
  stated semantics (the JAX package's flax BatchNorm, which the port
  keeps): batch statistics ``E[x^2] - E[x]^2`` clipped at 0, the biased
  variance in the running average, ``running = 0.9 * running + 0.1 *
  batch``; ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. The
  published VFS code runs torch's BatchNorm, whose running variance is
  the unbiased one: the one departure, noted here. In eval mode it is
  ``F.batch_norm`` on the running statistics.
- ``forward`` takes (N, H, W, C) and returns the (N, h, w, c) maps of
  ``out_indices``; ``blocks=True`` returns every block's output of those
  stages (the all-blocks eval).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

MOMENTUM = 0.9
EPS = 1e-5


class BatchNorm(nn.Module):
    """Affine BatchNorm over dim 1 with running statistics (module
    docstring)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer('running_mean', torch.zeros(c))
        self.register_buffer('running_var', torch.ones(c))
        self.register_buffer('num_batches_tracked',
                             torch.zeros((), dtype=torch.long))

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, EPS)
        dims = [d for d in range(x.dim()) if d != 1]
        mean = x.mean(dims)
        var = torch.clamp((x * x).mean(dims) - mean * mean, min=0.0)
        with torch.no_grad():
            self.running_mean.mul_(MOMENTUM).add_((1 - MOMENTUM)
                                                  * mean.detach())
            self.running_var.mul_(MOMENTUM).add_((1 - MOMENTUM)
                                                 * var.detach())
            self.num_batches_tracked.add_(1)
        shape = [1] * x.dim()
        shape[1] = x.shape[1]
        mul = torch.rsqrt(var + EPS) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) \
            + self.bias.view(shape)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 3, stride, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes, 1, stride, bias=False),
                BatchNorm(planes))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(out)) + idt)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int, stride: int):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        self.downsample = None
        if stride != 1 or cin != planes * 4:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, planes * 4, 1, stride, bias=False),
                BatchNorm(planes * 4))

    def forward(self, x):
        idt = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        return F.relu(self.bn3(self.conv3(out)) + idt)


LAYOUT = {18: (BasicBlock, (2, 2, 2, 2)), 50: (Bottleneck, (3, 4, 6, 3))}


class ResNet(nn.Module):

    def __init__(self, depth: int, strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (3,)):
        super().__init__()
        block, counts = LAYOUT[depth]
        self.out_indices = tuple(out_indices)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        cin = 64
        for i, n in enumerate(counts):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(n):
                blocks.append(block(cin, planes, strides[i] if j == 0
                                    else 1))
                cin = planes * block.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*blocks))
        self.feat_dim = cin

    def forward(self, x, blocks: bool = False):
        """(N, H, W, C) -> the (N, h, w, c) maps of ``out_indices`` (a
        single map for one index), or with ``blocks`` every block's output
        of those stages as a tuple."""
        x = x.permute(0, 3, 1, 2).contiguous()
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        outs = []
        for i in range(max(self.out_indices) + 1):
            for block in getattr(self, f'layer{i + 1}'):
                x = block(x)
                if blocks and i in self.out_indices:
                    outs.append(x.permute(0, 2, 3, 1))
            if not blocks and i in self.out_indices:
                outs.append(x.permute(0, 2, 3, 1))
        if blocks:
            return tuple(outs)
        return outs[0] if len(outs) == 1 else tuple(outs)
