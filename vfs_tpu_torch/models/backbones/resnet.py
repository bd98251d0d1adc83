"""ResNet backbone (PyTorch counterpart of
``vfs_tpu/models/backbones/resnet.py``).

Same capability surface: depths 18/34/50/101/152, ``out_indices``,
per-stage ``strides`` / ``dilations`` (the first block of a dilated stage
uses ``dilation // 2``), ``frozen_stages``, ``norm_eval``, zero-init
residual. Parameter names follow torchvision (``conv1``, ``bn1``,
``layer{i}.{j}.conv{n}`` / ``bn{n}`` / ``downsample.{0,1}``), so released
checkpoints load directly (``vfs_tpu_torch.checkpoint``).

The public seam keeps the JAX layout: ``forward`` takes ``(N, H, W, C)``
and returns ``(N, h, w, c)`` maps. Inside, the convolutions run on the
``channels_last`` view of the same memory (a permute, no copy). BatchNorm
uses eps 1e-5; in eval mode it uses the running statistics, in training
mode flax's statistics and update (``models/common/norm.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..common.norm import BatchNorm2d, frozen_running_stats
from ..registry import BACKBONES


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, dilation,
                               dilation, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.downsample = downsample

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn2

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """style='pytorch': the strided conv is the 3x3 conv2."""
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: Optional[nn.Module] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = BatchNorm2d(planes, eps=1e-5)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, dilation, dilation,
                               bias=False)
        self.bn2 = BatchNorm2d(planes, eps=1e-5)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm2d(planes * 4, eps=1e-5)
        self.downsample = downsample

    @property
    def last_bn(self) -> BatchNorm2d:
        return self.bn3

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


ARCH_SETTINGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    """ResNet backbone, NHWC in and out.

    Arguments mirror the JAX package's. ``pretrained`` and
    ``torchvision_pretrain`` are kept for config compatibility (weights
    load through the tracker). Training semantics:

    - a BatchNorm runs on its running statistics when its stage is frozen,
      under ``norm_eval``, and, with ``partial_bn``, everywhere but the
      stem; the parameters of frozen stages still take gradients and
      updates, as in the JAX package (the reference stops them too);
    - ``with_cp`` recomputes each residual block in the backward pass
      (``torch.utils.checkpoint``, non-reentrant); the recomputation
      leaves the running statistics alone, so a step updates them once;
    - ``sync_axis`` is accepted for config compatibility: in a training
      run over several processes every BatchNorm takes the global batch's
      statistics (``common.norm.set_sync_group``), as under GSPMD;
    - ``dtype='bfloat16'`` runs the forward under bf16 autocast (convs in
      bf16, BatchNorm statistics and parameters in fp32) and returns fp32
      maps.
    """

    def __init__(self, depth: int, in_channels: int = 3, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (3,), frozen_stages: int = -1,
                 norm_eval: bool = False, sync_axis: Optional[str] = None,
                 pretrained: Optional[str] = None,
                 torchvision_pretrain: bool = True,
                 zero_init_residual: bool = True, partial_bn: bool = False,
                 with_cp: bool = False, dtype='float32'):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet')
        dtype_name = str(dtype).rsplit('.', 1)[-1].strip("'>")
        if dtype_name not in ('float32', 'bfloat16'):
            raise ValueError(f'backbone dtype={dtype!r}: float32 or bfloat16')
        self.autocast_dtype = (torch.bfloat16 if dtype_name == 'bfloat16'
                               else None)
        self.partial_bn = partial_bn
        self.with_cp = with_cp
        self.depth = depth
        self.num_stages = num_stages
        self.strides = tuple(strides)
        self.dilations = tuple(dilations)
        self.out_indices = tuple(out_indices)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.zero_init_residual = zero_init_residual
        block, stage_blocks = ARCH_SETTINGS[depth]
        self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        inplanes = 64
        self.stage_names = []
        for i, num_blocks in enumerate(stage_blocks[:num_stages]):
            planes = 64 * 2**i
            stride, dilation = self.strides[i], self.dilations[i]
            downsample = None
            if stride != 1 or inplanes != planes * block.expansion:
                downsample = nn.Sequential(
                    nn.Conv2d(inplanes, planes * block.expansion, 1, stride,
                              bias=False),
                    BatchNorm2d(planes * block.expansion, eps=1e-5))
            first_dil = dilation if dilation == 1 else dilation // 2
            layers = [block(inplanes, planes, stride, first_dil, downsample)]
            inplanes = planes * block.expansion
            layers += [block(inplanes, planes, 1, dilation)
                       for _ in range(1, num_blocks)]
            name = f'layer{i + 1}'
            self.add_module(name, nn.Sequential(*layers))
            self.stage_names.append(name)
        self.feat_dim = inplanes

    @property
    def output_stride(self) -> int:
        out = 4
        for s in self.strides[:self.num_stages]:
            out *= s
        return out

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """Kaiming-normal convs (fan_out, relu), BN scale 1 / shift 0, and
        the last BN of each block zero when ``zero_init_residual``."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = (m.out_channels * m.kernel_size[0]
                               * m.kernel_size[1])
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                     generator=generator)
                elif isinstance(m, BatchNorm2d):
                    m.weight.fill_(1.0)
                    m.bias.zero_()
                    m.reset_running_stats()
            if self.zero_init_residual:
                for m in self.modules():
                    if isinstance(m, (BasicBlock, Bottleneck)):
                        m.last_bn.weight.zero_()

    def _stem(self, x):
        # (N, H, W, C) -> the channels_last NCHW view of the same memory
        x = x.permute(0, 3, 1, 2)
        return self.maxpool(F.relu(self.bn1(self.conv1(x))))

    @staticmethod
    def _nhwc(x):
        return x.permute(0, 2, 3, 1).contiguous()

    def _live_stages(self):
        """Stage names up to the last one in ``out_indices``: later stages
        feed no output, so they do not run (their weights stay, so state
        dicts and checkpoints are unchanged)."""
        return self.stage_names[:max(self.out_indices) + 1]

    def _block(self, block, x):
        if self.with_cp and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False,
                              context_fn=lambda: (
                                  contextlib.nullcontext(),
                                  frozen_running_stats(block)))
        return block(x)

    def forward(self, x):
        """``x`` (N, H, W, C) -> the stage outputs at ``out_indices`` as
        (N, h, w, c); a single map when there is one index."""
        if self.autocast_dtype is not None:
            with torch.autocast(x.device.type, dtype=self.autocast_dtype):
                outs = self._forward(x)
            outs = outs if isinstance(outs, tuple) else (outs,)
            outs = tuple(o.float() for o in outs)
            return outs[0] if len(outs) == 1 else outs
        return self._forward(x)

    def _forward(self, x):
        x = self._stem(x)
        outs = []
        for i, name in enumerate(self._live_stages()):
            for block in getattr(self, name):
                x = self._block(block, x)
            if i in self.out_indices:
                outs.append(self._nhwc(x))
        return outs[0] if len(outs) == 1 else tuple(outs)

    def _freeze_stages(self):
        if self.frozen_stages >= 0:
            frozen = [self.conv1, self.bn1] + [
                getattr(self, f'layer{i}')
                for i in range(1, self.frozen_stages + 1)]
            for m in frozen:
                m.eval()

    def train(self, mode: bool = True):
        super().train(mode)
        self._freeze_stages()
        if mode and (self.norm_eval or self.partial_bn):
            # partial_bn: the stem's BN alone keeps training
            keep = self.bn1 if not self.norm_eval else None
            for m in self.modules():
                if isinstance(m, BatchNorm2d) and m is not keep:
                    m.eval()
        return self


class ResNetBlockwise(ResNet):
    """All-blocks eval: the activation after every block of the stages in
    ``out_indices``, the other stages run normally. Same parameters as
    ``ResNet``."""

    def _forward(self, x):
        x = self._stem(x)
        outs = []
        for i, name in enumerate(self._live_stages()):
            for block in getattr(self, name):
                x = self._block(block, x)
                if i in self.out_indices:
                    outs.append(self._nhwc(x))
        return tuple(outs)
