"""SimSiam projection and prediction heads (counterpart of
``vfs_tpu/models/heads/sim_siam_head.py``; reference:
mmaction/models/heads/sim_siam_head.py:14-284).

``SimSiamHead``: optional convs, a global average pool, the projection MLP
(``num_projection_fcs`` x [Linear, BN] with ReLU between, BN on the last
too) and the predictor MLP (Linear, BN, ReLU except after the last
Linear). Linear layers carry a bias, as flax's ``Dense`` does; every
BatchNorm has flax's training semantics (``common.norm``), global over the
processes of a training run. Inputs are channels-last ``(N, H, W, C)``.
Submodule names follow the flax tree (``projection_fc{i}.fc`` / ``.bn``,
``predictor_fc{i}``, ``conv{i}``, ``conv_bn{i}``), so
``checkpoint.flax_simsiam_to_torch`` maps it leaf by leaf.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..builder import build_loss
from ..common.norm import BatchNorm1d, BatchNorm2d
from ..registry import HEADS


class MLPBlock(nn.Module):
    """Linear, then BatchNorm and ReLU where asked."""

    def __init__(self, in_features: int, features: int, with_bn: bool = True,
                 with_relu: bool = True):
        super().__init__()
        self.fc = nn.Linear(in_features, features)
        self.bn = BatchNorm1d(features, eps=1e-5) if with_bn else None
        self.with_relu = with_relu

    def forward(self, x):
        x = self.fc(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.with_relu else x


@HEADS.register_module()
class SimSiamHead(nn.Module):

    def __init__(self, in_channels: int, num_projection_fcs: int = 3,
                 projection_mid_channels: int = 2048,
                 projection_out_channels: int = 2048,
                 num_predictor_fcs: int = 2,
                 predictor_mid_channels: int = 512,
                 predictor_out_channels: int = 2048, with_norm: bool = True,
                 loss_feat: Optional[Dict[str, Any]] = None,
                 spatial_type: str = 'avg', num_convs: int = 0,
                 conv_mid_channels: int = 2048,
                 conv_out_channles: int = 2048, kernel_size: int = 1,
                 norm_cfg: Any = None, sync_axis: Optional[str] = None):
        super().__init__()
        self.loss_feat = build_loss(dict(
            loss_feat or dict(type='CosineSimLoss', negative=False)))
        self.spatial_type = spatial_type
        self.num_convs = num_convs
        self.num_projection_fcs = num_projection_fcs
        self.num_predictor_fcs = num_predictor_fcs
        c = in_channels
        for i in range(num_convs):
            is_last = i == num_convs - 1
            out = conv_out_channles if is_last else conv_mid_channels
            self.add_module(f'conv{i}', nn.Conv2d(
                c, out, kernel_size, padding='same', bias=False))
            if not is_last:
                self.add_module(f'conv_bn{i}', BatchNorm2d(out, eps=1e-5))
            c = out
        for i in range(num_projection_fcs):
            is_last = i == num_projection_fcs - 1
            out = projection_out_channels if is_last \
                else projection_mid_channels
            self.add_module(f'projection_fc{i}', MLPBlock(
                c, out, with_bn=True, with_relu=not is_last))
            c = out
        for i in range(num_predictor_fcs):
            is_last = i == num_predictor_fcs - 1
            out = predictor_out_channels if is_last \
                else predictor_mid_channels
            self.add_module(f'predictor_fc{i}', MLPBlock(
                c, out, with_bn=not is_last, with_relu=not is_last))
            c = out

    def forward(self, x):
        """x (N, H, W, C) map (or (N, C)) -> (z, p), each (N, out)."""
        if self.num_convs:
            x = x.permute(0, 3, 1, 2)
            for i in range(self.num_convs):
                x = getattr(self, f'conv{i}')(x)
                if i < self.num_convs - 1:
                    x = F.relu(getattr(self, f'conv_bn{i}')(x))
            x = x.permute(0, 2, 3, 1)
        if self.spatial_type == 'avg' and x.dim() == 4:
            x = torch.mean(x, dim=(1, 2))
        z = x
        for i in range(self.num_projection_fcs):
            z = getattr(self, f'projection_fc{i}')(z)
        p = z
        for i in range(self.num_predictor_fcs):
            p = getattr(self, f'predictor_fc{i}')(p)
        return z, p

    def loss(self, p1, z1, p2, z2, weight=1.0):
        """The symmetric stop-gradient loss (reference
        sim_siam_head.py:165-174), per sample."""
        loss = (self.loss_feat(p1, z2.detach()) * 0.5
                + self.loss_feat(p2, z1.detach()) * 0.5)
        return {'loss_feat': loss * weight}


@HEADS.register_module()
class DenseSimSiamHead(nn.Module):
    """Per-position (conv) SimSiam: maps in, maps out; the loss is
    pairwise over positions (reference sim_siam_head.py:177-284).
    Registered for config compatibility; no shipped config uses it."""

    def __init__(self, in_channels: int, kernel_size: int = 1,
                 num_projection_convs: int = 3,
                 projection_mid_channels: int = 2048,
                 projection_out_channels: int = 2048,
                 num_predictor_convs: int = 2,
                 predictor_mid_channels: int = 512,
                 predictor_out_channels: int = 2048,
                 loss_feat: Optional[Dict[str, Any]] = None,
                 norm_cfg: Any = None, sync_axis: Optional[str] = None):
        super().__init__()
        self.loss_feat = build_loss(dict(
            loss_feat or dict(type='CosineSimLoss', negative=False,
                              pairwise=True)))
        self.num_projection_convs = num_projection_convs
        self.num_predictor_convs = num_predictor_convs
        c = in_channels
        for i in range(num_projection_convs):
            is_last = i == num_projection_convs - 1
            out = projection_out_channels if is_last \
                else projection_mid_channels
            self.add_module(f'projection_conv{i}', nn.Conv2d(
                c, out, kernel_size, padding='same', bias=False))
            self.add_module(f'projection_bn{i}', BatchNorm2d(out, eps=1e-5))
            c = out
        for i in range(num_predictor_convs):
            is_last = i == num_predictor_convs - 1
            out = predictor_out_channels if is_last \
                else predictor_mid_channels
            self.add_module(f'predictor_conv{i}', nn.Conv2d(
                c, out, kernel_size, padding='same', bias=False))
            if not is_last:
                self.add_module(f'predictor_bn{i}',
                                BatchNorm2d(out, eps=1e-5))
            c = out

    def forward(self, x):
        """x (N, H, W, C) -> (z, p) maps, channels-last."""
        z = x.permute(0, 3, 1, 2)
        for i in range(self.num_projection_convs):
            z = getattr(self, f'projection_bn{i}')(
                getattr(self, f'projection_conv{i}')(z))
            if i < self.num_projection_convs - 1:
                z = F.relu(z)
        p = z
        for i in range(self.num_predictor_convs):
            p = getattr(self, f'predictor_conv{i}')(p)
            if i < self.num_predictor_convs - 1:
                p = F.relu(getattr(self, f'predictor_bn{i}')(p))
        return z.permute(0, 2, 3, 1), p.permute(0, 2, 3, 1)

    def loss(self, p1, z1, p2, z2, mask12=None, mask21=None, weight=1.0):
        loss = (self.loss_feat(p1, z2.detach(), mask12) * 0.5
                + self.loss_feat(p2, z1.detach(), mask21) * 0.5)
        return {'loss_feat': loss * weight}
