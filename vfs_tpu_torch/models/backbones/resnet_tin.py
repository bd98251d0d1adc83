"""ResNet-TIN: the temporal interlacing network (counterpart of
``vfs_tpu/models/backbones/resnet_tin.py``; reference:
mmaction/models/backbones/resnet_tin.py).

``ResNetTSM`` with a ``TemporalInterlace`` module in front of every
block's first convolution instead of the fixed shift: 1/``shift_div`` of
the channels, in four groups, move along time by a learnt fractional
offset a clip (two groups by +offset, two by -offset) and are scaled by a
learnt weight a segment. mmcv's CUDA ``tin_shift`` becomes a gather along
T with zeros outside the clip; ``linear_sampler`` interpolates between the
floor and the ceiling offsets, so the gradient reaches the offsets through
the interpolation weights alone (``floor`` has none).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn

from ..registry import BACKBONES
from .resnet import BasicBlock, Bottleneck
from .resnet_tsm import ResNetTSM


def tin_shift(data: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """Group-wise temporal shift (mmcv.ops.tin_shift): ``data`` (N, T, C,
    M), its channels in ``offset.shape[1]`` equal groups; group g at time
    t reads time ``t - offset[n, g]``, zeros outside [0, T)."""
    n, t, c, m = data.shape
    toff = offset.long().repeat_interleave(c // offset.shape[1], dim=1)
    t_src = torch.arange(t, device=data.device)[None, :, None] \
        - toff[:, None, :]                                   # (N, T, C)
    valid = (t_src >= 0) & (t_src < t)
    idx = t_src.clamp(0, t - 1)[..., None].expand(n, t, c, m)
    gathered = torch.gather(data, 1, idx)
    return torch.where(valid[..., None], gathered, torch.zeros_like(gathered))


def linear_sampler(data: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """``data`` (N, T, C, H, W) sampled at the fractional offsets
    ``offset`` (N, groups) (reference resnet_tin.py:15-62)."""
    n, t, c, h, w = data.shape
    offset0 = torch.floor(offset).detach()
    flat = data.reshape(n, t, c, h * w)
    data0 = tin_shift(flat, offset0)
    data1 = tin_shift(flat, offset0 + 1)
    weight0 = 1 - (offset - offset0)
    group_size = c // offset.shape[1]
    w0 = weight0.repeat_interleave(group_size, dim=1)[:, None, :, None]
    w1 = (1 - weight0).repeat_interleave(group_size, dim=1)[:, None, :, None]
    return (w0 * data0 + w1 * data1).reshape(n, t, c, h, w)


class OffsetNet(nn.Module):
    """A 1-D conv over the pooled descriptor, two fcs -> offsets in (-2,
    2) (reference :150-214); ``fc2``'s bias starts at 0.5108."""

    def __init__(self, in_channels: int, groups: int, num_segments: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, 1, 3, padding=1)
        self.fc1 = nn.Linear(num_segments, num_segments)
        self.fc2 = nn.Linear(num_segments, groups)

    def flax_init(self, generator=None):
        self.fc2.bias.fill_(0.5108)

    def forward(self, x):
        # x: (N, C, T)
        x = self.conv(x)[:, 0]                                  # (N, T)
        x = self.fc2(torch.relu(self.fc1(x)))
        return 4 * (torch.sigmoid(x[:, None]) - 0.5)            # (N, 1, G)


class WeightNet(nn.Module):
    """A 1-D conv -> weights in (0, 2) a segment and group (reference
    :96-148)."""

    def __init__(self, in_channels: int, groups: int):
        super().__init__()
        self.conv = nn.Conv1d(in_channels, groups, 3, padding=1)

    def forward(self, x):
        # x: (N, C, T) -> (N, T, groups)
        return 2 * torch.sigmoid(self.conv(x)).transpose(1, 2)


class TemporalInterlace(nn.Module):
    """Reference :216-304, two deformable groups. NCHW in and out,
    ``N * num_segments`` rows."""
    deform_groups = 2

    def __init__(self, in_channels: int, num_segments: int = 3,
                 shift_div: int = 1):
        super().__init__()
        self.num_segments = num_segments
        self.num_folds = in_channels // shift_div
        self.offset_net = OffsetNet(self.num_folds, self.deform_groups,
                                    num_segments)
        self.weight_net = WeightNet(self.num_folds, self.deform_groups)

    def forward(self, x):
        nt, c, h, w = x.shape
        t, folds = self.num_segments, self.num_folds
        n = nt // t
        x_desc = x[:, :folds].reshape(n, t, folds, h, w)
        x_pooled = torch.mean(x_desc, dim=(3, 4)).transpose(1, 2)  # N, F, T
        x_offset = self.offset_net(x_pooled).reshape(n, -1)
        x_weight = self.weight_net(x_pooled)                    # (N, T, 2)
        x_offset = torch.cat([x_offset, -x_offset], dim=1)      # (N, 4)
        x_shift = linear_sampler(x_desc, x_offset)
        # group g of the four (folds / 4 channels each) takes weight g // 2
        xw = x_weight.repeat_interleave(2, dim=2).repeat_interleave(
            folds // (2 * self.deform_groups), dim=2)           # (N, T, F)
        x_shift = (x_shift * xw[..., None, None]).reshape(nt, folds, h, w)
        return torch.cat([x_shift, x[:, folds:]], dim=1)


class TINBasicBlock(BasicBlock):

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, num_segments=8, shift_div=4):
        super().__init__(inplanes, planes, stride, dilation, downsample)
        self.tin = TemporalInterlace(inplanes, num_segments, shift_div)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(self.tin(x))))
        out = self.bn2(self.conv2(out))
        return torch.relu(out + identity)


class TINBottleneck(Bottleneck):

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, num_segments=8, shift_div=4):
        super().__init__(inplanes, planes, stride, dilation, downsample)
        self.tin = TemporalInterlace(inplanes, num_segments, shift_div)

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = torch.relu(self.bn1(self.conv1(self.tin(x))))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return torch.relu(out + identity)


@BACKBONES.register_module()
class ResNetTIN(ResNetTSM):
    """Reference resnet_tin.py:306-380; ``is_tin=False`` takes the plain
    blocks."""
    blocks = (TINBasicBlock, TINBottleneck)

    def __init__(self, depth: int, num_segments: int = 8, is_tin: bool = True,
                 shift_div: int = 4, pretrained: Optional[str] = None,
                 out_indices: Sequence[int] = (3,), norm_eval: bool = False,
                 strides: Sequence[int] = (1, 2, 2, 2)):
        super().__init__(depth, num_segments, is_tin, shift_div, pretrained,
                         out_indices, norm_eval, strides)
