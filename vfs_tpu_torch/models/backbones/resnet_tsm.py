"""ResNet-TSM: a 2-D ResNet with temporal shift (counterpart of
``vfs_tpu/models/backbones/resnet_tsm.py``; reference:
mmaction/models/backbones/resnet_tsm.py:40-294, ``shift_place='blockres'``).

NCHW in and out, ``N * num_segments`` rows. Each residual block shifts
1/``shift_div`` of its input's channels one segment back in time and as
many one segment forward before its first convolution (zeros at the clip
edges); the identity path takes the unshifted input. The blocks are the
port's ``ResNet`` blocks with the shift in front, so the parameter names
are torchvision's (``conv1``, ``bn1``, ``layer{i}.{j}.conv{n}`` /
``bn{n}`` / ``downsample.{0,1}``). A block flagged in ``non_local`` is
followed by an ``NL3DWrapper`` at ``layer{i}_nl.{j}``.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..common.non_local import NL3DWrapper, non_local_kwargs
from ..common.norm import BatchNorm2d, NormEvalModule
from ..registry import BACKBONES
from .resnet import ARCH_SETTINGS, BasicBlock, Bottleneck


def temporal_shift(x: torch.Tensor, num_segments: int,
                   shift_div: int = 8) -> torch.Tensor:
    """(N*T, C, H, W) -> shifted along T: channels [0, fold) take segment
    t+1's values, [fold, 2*fold) segment t-1's, zeros past the clip's
    edges (reference resnet_tsm.py:125-160)."""
    nt, c, h, w = x.shape
    x = x.reshape(nt // num_segments, num_segments, c, h, w)
    fold = c // shift_div
    out = torch.zeros_like(x)
    out[:, :-1, :fold] = x[:, 1:, :fold]
    out[:, 1:, fold:2 * fold] = x[:, :-1, fold:2 * fold]
    out[:, :, 2 * fold:] = x[:, :, 2 * fold:]
    return out.reshape(nt, c, h, w)


class TSMBasicBlock(BasicBlock):

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, num_segments=8, shift_div=8):
        super().__init__(inplanes, planes, stride, dilation, downsample)
        self.num_segments = num_segments
        self.shift_div = shift_div

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = temporal_shift(x, self.num_segments, self.shift_div)
        out = F.relu(self.bn1(self.conv1(out)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class TSMBottleneck(Bottleneck):

    def __init__(self, inplanes, planes, stride=1, dilation=1,
                 downsample=None, num_segments=8, shift_div=8):
        super().__init__(inplanes, planes, stride, dilation, downsample)
        self.num_segments = num_segments
        self.shift_div = shift_div

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = temporal_shift(x, self.num_segments, self.shift_div)
        out = F.relu(self.bn1(self.conv1(out)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


@BACKBONES.register_module()
class ResNetTSM(NormEvalModule):
    """``is_shift=False`` takes the plain blocks (reference
    resnet_tsm.py:289). ``norm_eval`` keeps every BatchNorm on its running
    statistics in training mode."""
    # (basic, bottleneck) blocks with the temporal module in front
    blocks = (TSMBasicBlock, TSMBottleneck)

    def __init__(self, depth: int, num_segments: int = 8,
                 is_shift: bool = True, shift_div: int = 8,
                 pretrained: Optional[str] = None,
                 out_indices: Sequence[int] = (3,), norm_eval: bool = False,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 non_local: Sequence = (0, 0, 0, 0),
                 non_local_cfg: Any = None):
        super().__init__()
        if depth not in ARCH_SETTINGS:
            raise KeyError(f'invalid depth {depth} for resnet')
        block2d, stage_blocks = ARCH_SETTINGS[depth]
        block = block2d
        if is_shift:
            block = self.blocks[block2d.expansion != 1]
        self.num_segments = num_segments
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm2d(64, eps=1e-5)
        non_locals = tuple(non_local) if non_local else \
            (0,) * len(stage_blocks)
        nl_kwargs = non_local_kwargs(non_local_cfg)
        inplanes = 64
        for i, num_blocks in enumerate(stage_blocks):
            planes = 64 * 2**i
            stage_nl = non_locals[i] if i < len(non_locals) else 0
            stage_nl = tuple(stage_nl) if isinstance(
                stage_nl, (tuple, list)) else (stage_nl,) * num_blocks
            layers, nls = [], nn.ModuleDict()
            for j in range(num_blocks):
                stride = strides[i] if j == 0 else 1
                downsample = None
                if j == 0 and (stride != 1
                               or inplanes != planes * block.expansion):
                    downsample = nn.Sequential(
                        nn.Conv2d(inplanes, planes * block.expansion, 1,
                                  stride, bias=False),
                        BatchNorm2d(planes * block.expansion, eps=1e-5))
                kwargs = dict(num_segments=num_segments,
                              shift_div=shift_div) if is_shift else {}
                layers.append(block(inplanes, planes, stride, 1, downsample,
                                    **kwargs))
                inplanes = planes * block.expansion
                if stage_nl[j]:
                    nls[str(j)] = NL3DWrapper(inplanes, num_segments,
                                              **nl_kwargs)
            self.add_module(f'layer{i + 1}', nn.Sequential(*layers))
            if len(nls):
                self.add_module(f'layer{i + 1}_nl', nls)
        self.num_stages = len(stage_blocks)
        self.feat_dim = inplanes

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            nls = getattr(self, f'layer{i + 1}_nl', {})
            for j, block in enumerate(getattr(self, f'layer{i + 1}')):
                x = block(x)
                if str(j) in nls:
                    x = nls[str(j)](x)
            if i in self.out_indices:
                outs.append(x)
        return outs[0] if len(outs) == 1 else tuple(outs)
