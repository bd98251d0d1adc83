"""SlowFast, R(2+1)D and CSN backbones (counterpart of
``vfs_tpu/models/backbones/resnet3d_variants.py``; reference:
mmaction/models/backbones/resnet3d_slowfast.py:12-487, resnet2plus1d.py
with common/conv2plus1d.py, resnet3d_csn.py:14-148).

NCTHW in and out. ``ResNet3dSlowFast`` returns (slow, fast) maps; each
pathway (``slow_path``, ``fast_path``) holds its stem ``conv1``, its
stages and, on the slow side, the lateral convolutions ``lateral{i}``
(bare convolutions: no norm, no activation) whose outputs are
concatenated after the slow stem and each slow stage but the last. In
training mode ``norm_eval`` keeps every BatchNorm on its running
statistics.

Spans (``utils.trace``): ``slowfast.slow`` and ``slowfast.fast`` around
each pathway's stem and each of its stages, ``slowfast.lateral`` around
each lateral with its concatenation; the counter
``slowfast.concat_bytes`` adds the bytes each concatenation writes.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...utils import trace
from ..common.norm import BatchNorm3d, NormEvalModule
from ..registry import BACKBONES
from .resnet3d import ARCH_SETTINGS_3D, ConvBN3d, _ntuple, max_pool_3d


class _Pathway(nn.Module):
    """One SlowFast pathway (reference ResNet3dPathway)."""

    def __init__(self, depth, base_channels=64, lateral=False, speed_ratio=8,
                 channel_ratio=8, fusion_kernel=5, conv1_kernel=(1, 7, 7),
                 conv1_stride_t=1, pool1_stride_t=1, inflate=(1, 1, 1, 1),
                 inflate_style='3x1x1', spatial_strides=(1, 2, 2, 2),
                 temporal_strides=(1, 1, 1, 1), with_pool2=False,
                 pretrained=None, type=None, dilations=(1, 1, 1, 1),
                 norm_eval=False, lateral_inplanes=None):
        super().__init__()
        # dilations other than 1 are in no SlowFast config of the
        # reference (resnet3d_slowfast.py:376-398), nor of the JAX package
        assert tuple(dilations) == (1, 1, 1, 1), \
            'SlowFast pathway dilations != 1 not supported'
        block, stage_blocks = ARCH_SETTINGS_3D[depth]
        self.pool1_stride_t = pool1_stride_t
        self.lateral = lateral
        self.num_stages = len(stage_blocks)
        self.conv1 = ConvBN3d(3, base_channels, conv1_kernel,
                              (conv1_stride_t, 2, 2))
        # lateral i takes the fast pathway's stem (i = 0) or stage i
        # output and gives 2 / channel_ratio of the slow channels beside
        # which it is concatenated
        lat = [0] * (self.num_stages + 1)
        if lateral:
            fast = lateral_inplanes
            for i in range(self.num_stages):
                c_in = fast[i]
                c_out = base_channels if i == 0 else \
                    base_channels * 2**(i - 1) * block.expansion
                lat[i] = c_out * 2 // channel_ratio
                self.add_module(f'lateral{i}', ConvBN3d(
                    c_in, lat[i], (fusion_kernel, 1, 1), (speed_ratio, 1, 1),
                    ((fusion_kernel - 1) // 2, 0, 0), act=False,
                    with_bn=False))
        inflates = _ntuple(inflate, 4)
        inplanes = base_channels + lat[0]
        self.out_channels = [base_channels]
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            stage_inflate = _ntuple(inflates[i], num_blocks)
            layers = []
            for j in range(num_blocks):
                ss = spatial_strides[i] if j == 0 else 1
                ts = temporal_strides[i] if j == 0 else 1
                with_ds = j == 0 and (ss != 1 or ts != 1
                                      or inplanes != planes * block.expansion)
                layers.append(block(inplanes, planes, ss, ts, 1,
                                    bool(stage_inflate[j]), with_ds,
                                    inflate_style=inflate_style))
                inplanes = planes * block.expansion
            self.add_module(f'layer{i + 1}', nn.Sequential(*layers))
            self.out_channels.append(inplanes)
            if i + 1 < self.num_stages:
                inplanes += lat[i + 1]

    def stem(self, x):
        return max_pool_3d(self.conv1(x), (1, 3, 3),
                           (self.pool1_stride_t, 2, 2), (0, 1, 1))


@BACKBONES.register_module()
class ResNet3dSlowFast(NormEvalModule):
    """Two-pathway SlowFast (reference resnet3d_slowfast.py:354-487)."""

    def __init__(self, pretrained: Optional[str] = None,
                 resample_rate: int = 8, speed_ratio: int = 8,
                 channel_ratio: int = 8, slow_pathway: Any = None,
                 fast_pathway: Any = None, norm_eval: bool = False):
        super().__init__()
        self.resample_rate = resample_rate
        self.speed_ratio = speed_ratio
        self.norm_eval = norm_eval
        slow_cfg = dict(slow_pathway or dict(
            depth=50, lateral=True, conv1_kernel=(1, 7, 7),
            conv1_stride_t=1, pool1_stride_t=1, inflate=(0, 0, 1, 1)))
        fast_cfg = dict(fast_pathway or dict(
            depth=50, lateral=False, base_channels=8,
            conv1_kernel=(5, 7, 7), conv1_stride_t=1, pool1_stride_t=1))
        self.fast_path = _Pathway(**fast_cfg)
        if slow_cfg.get('lateral'):
            slow_cfg.update(speed_ratio=speed_ratio,
                            channel_ratio=channel_ratio,
                            lateral_inplanes=self.fast_path.out_channels)
        self.slow_path = _Pathway(**slow_cfg)

    def forward(self, x):
        slow, fast = self.slow_path, self.fast_path
        with trace.span('slowfast.slow'):
            x_slow = slow.stem(x[:, :, ::self.resample_rate])
        with trace.span('slowfast.fast'):
            x_fast = fast.stem(
                x[:, :, ::max(self.resample_rate // self.speed_ratio, 1)])
        if slow.lateral:
            x_slow = self._fuse(x_slow, x_fast, 0)
        for i in range(slow.num_stages):
            with trace.span('slowfast.slow'):
                x_slow = getattr(slow, f'layer{i + 1}')(x_slow)
            with trace.span('slowfast.fast'):
                x_fast = getattr(fast, f'layer{i + 1}')(x_fast)
            if i != slow.num_stages - 1 and slow.lateral:
                x_slow = self._fuse(x_slow, x_fast, i + 1)
        return x_slow, x_fast

    def _fuse(self, x_slow, x_fast, i: int):
        """The slow maps with lateral ``i`` of the fast maps concatenated
        on their channels; counts the bytes the concatenation writes."""
        with trace.span('slowfast.lateral'):
            lat = getattr(self.slow_path, f'lateral{i}')(x_fast)
            out = torch.cat([x_slow, lat], dim=1)
        trace.count('slowfast.concat_bytes', out.numel() * out.element_size())
        return out


def conv2plus1d_mid(in_c: int, features: int, kh: int, kw: int) -> int:
    """The reference's mid-channel count (conv2plus1d.py:61-65), with the
    temporal factor 3 whatever the actual kt (the 1x1x1 downsample too)."""
    return max((3 * in_c * features * kh * kw)
               // (in_c * kh * kw + 3 * features), 1)


class Conv2Plus1d(nn.Module):
    """Spatial (1, k, k) conv, BatchNorm, ReLU, temporal (k, 1, 1) conv
    (reference common/conv2plus1d.py)."""

    def __init__(self, in_channels: int, features: int,
                 kernel=(3, 3, 3), strides=(1, 1, 1)):
        super().__init__()
        kt, kh, kw = kernel
        st, sh, sw = strides
        mid = conv2plus1d_mid(in_channels, features, kh, kw)
        self.conv_s = nn.Conv3d(in_channels, mid, (1, kh, kw), (1, sh, sw),
                                (0, kh // 2, kw // 2), bias=False)
        self.bn_s = BatchNorm3d(mid, eps=1e-5)
        self.conv_t = nn.Conv3d(mid, features, (kt, 1, 1), (st, 1, 1),
                                (kt // 2, 0, 0), bias=False)

    def forward(self, x):
        return self.conv_t(F.relu(self.bn_s(self.conv_s(x))))


class Block2Plus1d(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, spatial_stride=1, temporal_stride=1,
                 with_downsample=False):
        super().__init__()
        stride = (temporal_stride, spatial_stride, spatial_stride)
        self.conv1 = Conv2Plus1d(inplanes, planes, (3, 3, 3), stride)
        self.bn1 = BatchNorm3d(planes, eps=1e-5)
        self.conv2 = Conv2Plus1d(planes, planes, (3, 3, 3))
        self.bn2 = BatchNorm3d(planes, eps=1e-5)
        if with_downsample:
            # the reference builds the downsample with the same conv_cfg:
            # a factorised 1x1x1 Conv2plus1d and a BatchNorm
            self.downsample = Conv2Plus1d(inplanes, planes, (1, 1, 1),
                                          stride)
            self.downsample_bn = BatchNorm3d(planes, eps=1e-5)
        else:
            self.downsample = None

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample_bn(self.downsample(x))
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNet2Plus1d(NormEvalModule):
    """R(2+1)D (reference resnet2plus1d.py:6-49): ``Conv2Plus1d``
    everywhere, no pool2, the last stage's maps out."""

    def __init__(self, depth: int, pretrained: Optional[str] = None,
                 base_channels: int = 64,
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 2, 2, 2),
                 conv1_kernel: Tuple[int, int, int] = (3, 7, 7),
                 conv1_stride_t: int = 1, pool1_stride_t: int = 1,
                 norm_eval: bool = False):
        super().__init__()
        _, stage_blocks = ARCH_SETTINGS_3D[depth]
        self.norm_eval = norm_eval
        self.pool1_stride_t = pool1_stride_t
        self.conv1 = Conv2Plus1d(3, base_channels, tuple(conv1_kernel),
                                 (conv1_stride_t, 2, 2))
        self.bn1 = BatchNorm3d(base_channels, eps=1e-5)
        inplanes = base_channels
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            layers = []
            for j in range(num_blocks):
                ss = spatial_strides[i] if j == 0 else 1
                ts = temporal_strides[i] if j == 0 else 1
                with_ds = j == 0 and (ss != 1 or ts != 1
                                      or inplanes != planes)
                layers.append(Block2Plus1d(inplanes, planes, ss, ts, with_ds))
                inplanes = planes
            self.add_module(f'layer{i + 1}', nn.Sequential(*layers))
        self.num_stages = len(stage_blocks)
        self.feat_dim = inplanes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = max_pool_3d(x, (1, 3, 3), (self.pool1_stride_t, 2, 2), (0, 1, 1))
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
        return x


class CSNBottleneck(nn.Module):
    """Channel-separated bottleneck: a depthwise 3x3x3 conv2 ('ir'), with
    a 1x1x1 conv before it in 'ip' mode (reference resnet3d_csn.py:14-66)."""
    expansion = 4

    def __init__(self, inplanes, planes, spatial_stride=1, temporal_stride=1,
                 bottleneck_mode='ir', with_downsample=False):
        super().__init__()
        stride = (temporal_stride, spatial_stride, spatial_stride)
        self.conv1 = ConvBN3d(inplanes, planes, 1)
        self.conv2_ip = nn.Conv3d(planes, planes, 1, bias=False) \
            if bottleneck_mode == 'ip' else None
        self.conv2_dw = nn.Conv3d(planes, planes, 3, stride, 1, groups=planes,
                                  bias=False)
        self.bn2 = BatchNorm3d(planes, eps=1e-5)
        self.conv3 = ConvBN3d(planes, planes * self.expansion, 1, act=False)
        self.downsample = ConvBN3d(inplanes, planes * self.expansion, 1,
                                   stride, 0, act=False) \
            if with_downsample else None

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = self.conv1(x)
        if self.conv2_ip is not None:
            out = self.conv2_ip(out)
        out = F.relu(self.bn2(self.conv2_dw(out)))
        return F.relu(self.conv3(out) + identity)


@BACKBONES.register_module()
class ResNet3dCSN(NormEvalModule):
    """ir-CSN / ip-CSN (reference resnet3d_csn.py:69-148), with
    ``ResNet3d``'s pool2 by default."""

    def __init__(self, depth: int, pretrained: Optional[str] = None,
                 base_channels: int = 64, bottleneck_mode: str = 'ir',
                 spatial_strides: Sequence[int] = (1, 2, 2, 2),
                 temporal_strides: Sequence[int] = (1, 2, 2, 2),
                 conv1_kernel: Tuple[int, int, int] = (3, 7, 7),
                 conv1_stride_t: int = 1, pool1_stride_t: int = 1,
                 with_pool2: bool = True, norm_eval: bool = False):
        super().__init__()
        _, stage_blocks = ARCH_SETTINGS_3D[depth]
        self.norm_eval = norm_eval
        self.pool1_stride_t = pool1_stride_t
        self.with_pool2 = with_pool2
        self.conv1 = ConvBN3d(3, base_channels, conv1_kernel,
                              (conv1_stride_t, 2, 2))
        inplanes = base_channels
        for i, num_blocks in enumerate(stage_blocks):
            planes = base_channels * 2**i
            layers = []
            for j in range(num_blocks):
                ss = spatial_strides[i] if j == 0 else 1
                ts = temporal_strides[i] if j == 0 else 1
                with_ds = j == 0 and (ss != 1 or ts != 1
                                      or inplanes != planes * 4)
                layers.append(CSNBottleneck(inplanes, planes, ss, ts,
                                            bottleneck_mode, with_ds))
                inplanes = planes * 4
            self.add_module(f'layer{i + 1}', nn.Sequential(*layers))
        self.num_stages = len(stage_blocks)
        self.feat_dim = inplanes

    def forward(self, x):
        x = max_pool_3d(self.conv1(x), (1, 3, 3),
                        (self.pool1_stride_t, 2, 2), (0, 1, 1))
        for i in range(self.num_stages):
            x = getattr(self, f'layer{i + 1}')(x)
            if i == 0 and self.with_pool2:
                x = max_pool_3d(x, (2, 1, 1), (2, 1, 1), (0, 0, 0))
        return x
