"""3-D ResNet family (counterpart of ``vfs_tpu/models/backbones/
resnet3d.py``; reference: mmaction/models/backbones/resnet3d.py:13-808 and
resnet3d_slowonly.py).

NCTHW in and out. Convolutions and their BatchNorms are ``ConvBN3d``
pairs named as MMAction2's ConvModules (``layer{i}.{j}.conv{n}.conv`` /
``.bn``, ``downsample.conv`` / ``.bn``); a block flagged in ``non_local``
ends in a ``NonLocal3d`` (``non_local_block``). BatchNorm has flax's
training semantics (``common.norm.BatchNorm3d``). In training mode the
stem and the stages up to ``frozen_stages`` keep their BatchNorms on the
running statistics, and all of them do under ``norm_eval``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops import conv3d_wgrad
from ..common.non_local import NonLocal3d, non_local_kwargs
from ..common.norm import BatchNorm3d, frozen_running_stats
from ..registry import BACKBONES


def max_pool_3d(x, kernel, strides, padding):
    """Max pool with symmetric padding that never wins (-inf, as the JAX
    package's ``reduce_window``)."""
    return F.max_pool3d(x, tuple(kernel), tuple(strides), tuple(padding))


def _triple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * 3


def _ntuple(value, n):
    if isinstance(value, (tuple, list)):
        return tuple(value)
    return (value,) * n


def autocast_dtype(dtype):
    """A backbone's ``dtype`` argument -> the autocast type (None for
    fp32); the JAX package's flax dtypes by name."""
    name = str(dtype).rsplit('.', 1)[-1].strip("'>")
    if name not in ('float32', 'bfloat16'):
        raise ValueError(f'backbone dtype={dtype!r}: float32 or bfloat16')
    return torch.bfloat16 if name == 'bfloat16' else None


class ConvBN3d(nn.Module):
    """Conv3d [+ BatchNorm3d] [+ ReLU]; ``padding`` defaults to half the
    kernel. The convolution runs through ``ops.conv3d_wgrad.conv3d``: a
    narrow one's weight gradient on the card is a hand-written kernel, the
    rest cuDNN's."""

    def __init__(self, in_channels: int, features: int, kernel,
                 strides=(1, 1, 1), padding=None, dilation=(1, 1, 1),
                 act: bool = True, with_bn: bool = True, bias: bool = False,
                 zero_init_scale: bool = False, groups: int = 1):
        super().__init__()
        kernel = _triple(kernel)
        pad = _triple(padding) if padding is not None else tuple(
            k // 2 for k in kernel)
        self.conv = nn.Conv3d(in_channels, features, kernel, _triple(strides),
                              pad, _triple(dilation), groups=groups,
                              bias=bias)
        self.bn = BatchNorm3d(features, eps=1e-5) if with_bn else None
        self.act = act
        self.zero_init_scale = zero_init_scale

    def flax_init(self, generator=None):
        if self.bn is not None and self.zero_init_scale:
            self.bn.weight.zero_()

    def forward(self, x):
        x = conv3d_wgrad.conv3d(self.conv, x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.act else x


class BasicBlock3d(nn.Module):
    """Reference resnet3d.py:13-155."""
    expansion = 1

    def __init__(self, inplanes, planes, spatial_stride=1, temporal_stride=1,
                 dilation=1, inflate=True, with_downsample=False,
                 non_local=False, non_local_cfg=None, zero_init_last=False,
                 inflate_style=None):
        super().__init__()
        d = dilation
        k = (3, 3, 3) if inflate else (1, 3, 3)
        stride = (temporal_stride, spatial_stride, spatial_stride)
        self.conv1 = ConvBN3d(inplanes, planes, k, stride,
                              (1 if inflate else 0, d, d), (1, d, d))
        self.conv2 = ConvBN3d(planes, planes, k, act=False,
                              zero_init_scale=zero_init_last)
        self.downsample = ConvBN3d(inplanes, planes * self.expansion, 1,
                                   stride, 0, act=False) \
            if with_downsample else None
        self.non_local_block = NonLocal3d(
            planes * self.expansion, **non_local_kwargs(non_local_cfg)) \
            if non_local else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.conv2(self.conv1(x)) + identity)
        if self.non_local_block is not None:
            out = self.non_local_block(out)
        return out


class Bottleneck3d(nn.Module):
    """Reference resnet3d.py:155-321 (style='pytorch')."""
    expansion = 4

    def __init__(self, inplanes, planes, spatial_stride=1, temporal_stride=1,
                 dilation=1, inflate=True, with_downsample=False,
                 non_local=False, non_local_cfg=None, zero_init_last=False,
                 inflate_style='3x1x1'):
        super().__init__()
        d = dilation
        if inflate:
            k1, k2 = ((3, 1, 1), (1, 3, 3)) if inflate_style == '3x1x1' \
                else ((1, 1, 1), (3, 3, 3))
        else:
            k1, k2 = (1, 1, 1), (1, 3, 3)
        stride = (temporal_stride, spatial_stride, spatial_stride)
        self.conv1 = ConvBN3d(inplanes, planes, k1)
        self.conv2 = ConvBN3d(planes, planes, k2, stride, (k2[0] // 2, d, d),
                              (1, d, d))
        self.conv3 = ConvBN3d(planes, planes * self.expansion, 1, act=False,
                              zero_init_scale=zero_init_last)
        self.downsample = ConvBN3d(inplanes, planes * self.expansion, 1,
                                   stride, 0, act=False) \
            if with_downsample else None
        self.non_local_block = NonLocal3d(
            planes * self.expansion, **non_local_kwargs(non_local_cfg)) \
            if non_local else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv3(self.conv2(self.conv1(x)))
        out = F.relu(out + identity)
        if self.non_local_block is not None:
            out = self.non_local_block(out)
        return out


ARCH_SETTINGS_3D = {
    18: (BasicBlock3d, (2, 2, 2, 2)),
    34: (BasicBlock3d, (3, 4, 6, 3)),
    50: (Bottleneck3d, (3, 4, 6, 3)),
    101: (Bottleneck3d, (3, 4, 23, 3)),
    152: (Bottleneck3d, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet3d(nn.Module):
    """Reference resnet3d.py:321-760. ``with_cp`` recomputes each block in
    the backward pass (the running statistics update once a step);
    ``dtype='bfloat16'`` runs the forward under bf16 autocast and returns
    fp32 maps."""

    def __init__(self, depth: int, pretrained: Optional[str] = None,
                 pretrained2d: bool = True, in_channels: int = 3,
                 num_stages: int = 4, base_channels: int = 64,
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 1, 1, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 conv1_kernel: Tuple[int, int, int] = (5, 7, 7),
                 conv1_stride_t: int = 2, pool1_stride_t: int = 2,
                 with_pool2: bool = True, frozen_stages: int = -1,
                 inflate: Union[int, Sequence[int]] = (1, 1, 1, 1),
                 inflate_style: str = '3x1x1', norm_eval: bool = False,
                 zero_init_residual: bool = True,
                 out_indices: Sequence[int] = (3,), with_cp: bool = False,
                 non_local: Union[int, Sequence] = (0, 0, 0, 0),
                 non_local_cfg: Any = None, dtype='float32'):
        super().__init__()
        if depth not in ARCH_SETTINGS_3D:
            raise KeyError(f'invalid depth {depth} for resnet3d')
        self.autocast_dtype = autocast_dtype(dtype)
        block, stage_blocks = ARCH_SETTINGS_3D[depth]
        stage_blocks = stage_blocks[:num_stages]
        self.num_stages = len(stage_blocks)
        self.pool1_stride_t = pool1_stride_t
        self.with_pool2 = with_pool2
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.out_indices = tuple(out_indices)
        self.with_cp = with_cp
        self.conv1 = ConvBN3d(in_channels, base_channels, conv1_kernel,
                              (conv1_stride_t, 2, 2))
        inflates = _ntuple(inflate, num_stages)
        non_locals = _ntuple(non_local, num_stages)
        inplanes = base_channels
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            stage_inflate = _ntuple(inflates[i], num_blocks)
            stage_nl = _ntuple(non_locals[i], num_blocks)
            layers = []
            for j in range(num_blocks):
                ss = spatial_strides[i] if j == 0 else 1
                ts = temporal_strides[i] if j == 0 else 1
                with_ds = j == 0 and (ss != 1 or ts != 1
                                      or inplanes != planes * block.expansion)
                layers.append(block(
                    inplanes, planes, ss, ts, dilations[i],
                    bool(stage_inflate[j]), with_ds, bool(stage_nl[j]),
                    non_local_cfg, zero_init_residual, inflate_style))
                inplanes = planes * block.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*layers))
        self.feat_dim = inplanes

    def _block(self, block, x):
        if self.with_cp and self.training and torch.is_grad_enabled():
            return checkpoint(block, x, use_reentrant=False,
                              context_fn=lambda: (
                                  contextlib.nullcontext(),
                                  frozen_running_stats(block)))
        return block(x)

    def forward(self, x):
        if self.autocast_dtype is not None:
            with torch.autocast(x.device.type, dtype=self.autocast_dtype):
                outs = self._forward(x)
            if isinstance(outs, tuple):
                return tuple(o.float() for o in outs)
            return outs.float()
        return self._forward(x)

    def _forward(self, x):
        x = max_pool_3d(self.conv1(x), (1, 3, 3),
                        (self.pool1_stride_t, 2, 2), (0, 1, 1))
        outs = []
        for i in range(self.num_stages):
            for block in getattr(self, f'layer{i + 1}'):
                x = self._block(block, x)
            if i == 0 and self.with_pool2:
                x = max_pool_3d(x, (2, 1, 1), (2, 1, 1), (0, 0, 0))
            if i in self.out_indices:
                outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)

    def train(self, mode: bool = True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.modules.batchnorm._BatchNorm):
                    m.eval()
        elif mode and self.frozen_stages >= 0:
            for i in range(1, self.frozen_stages + 1):
                getattr(self, f'layer{i}').eval()
            self.conv1.eval()
        return self


@BACKBONES.register_module()
class ResNet3dSlowOnly(nn.Module):
    """SlowOnly: ``ResNet3d`` with a (1, 7, 7) stem, no temporal
    downsampling and inflation in the last two stages (reference
    resnet3d_slowonly.py:6-57)."""

    def __init__(self, depth: int, pretrained: Optional[str] = None,
                 in_channels: int = 3, lateral: bool = False,
                 conv1_kernel: Tuple[int, int, int] = (1, 7, 7),
                 conv1_stride_t: int = 1, pool1_stride_t: int = 1,
                 inflate: Sequence[int] = (0, 0, 1, 1),
                 with_pool2: bool = False, out_indices: Sequence[int] = (3,),
                 norm_eval: bool = False, dtype='float32'):
        super().__init__()
        self.resnet3d = ResNet3d(
            depth=depth, in_channels=in_channels, conv1_kernel=conv1_kernel,
            conv1_stride_t=conv1_stride_t, pool1_stride_t=pool1_stride_t,
            inflate=inflate, with_pool2=with_pool2, out_indices=out_indices,
            norm_eval=norm_eval, inflate_style='3x1x1', dtype=dtype)
        self.feat_dim = self.resnet3d.feat_dim

    def forward(self, x):
        return self.resnet3d(x)
