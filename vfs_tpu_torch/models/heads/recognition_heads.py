"""Recognition heads (counterpart of
``vfs_tpu/models/heads/recognition_heads.py``; reference:
mmaction/models/heads/{base,tsn_head,i3d_head,tsm_head,slowfast_head}.py).

Feature maps come in NCHW (2-D backbones, ``N * segments`` rows) or NCTHW
(3-D backbones); class scores go out. ``fc_cls`` starts at
``normal(init_std)`` with a zero bias, as the JAX heads' ``Dense`` does.
Dropout acts in training mode only, drawing from the ``generator`` the
recognizer passes down (the train step seeds one per step), with flax's
rule: keep with probability ``1 - p`` and scale the kept values by
``1 / (1 - p)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..builder import build_loss
from ..registry import HEADS


def head_loss(loss_cls, cls_score, labels, num_classes,
              label_smooth_eps=0.0, multi_class=False):
    """BaseHead.loss (reference heads/base.py:70-101): hard or soft labels
    as given; multi-class labels smoothed by ``label_smooth_eps``."""
    if multi_class and label_smooth_eps:
        labels = ((1 - label_smooth_eps) * labels +
                  label_smooth_eps / num_classes)
    return {'loss_cls': loss_cls(cls_score, labels)}


def dropout(x: torch.Tensor, p: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: zero each value with probability ``p`` and
    scale the rest by ``1 / (1 - p)``."""
    keep = torch.empty_like(x).bernoulli_(1 - p, generator=generator)
    return torch.where(keep.bool(), x / (1 - p), torch.zeros_like(x))


class _ClsHead(nn.Module):
    """``fc_cls``, the loss and the dropout shared by the four heads."""

    def __init__(self, num_classes, in_channels, loss_cls=None,
                 dropout_ratio=0.0, init_std=0.01, multi_class=False,
                 label_smooth_eps=0.0):
        super().__init__()
        self.num_classes = num_classes
        self.in_channels = in_channels
        self.dropout_ratio = dropout_ratio
        self.init_std = init_std
        self.multi_class = multi_class
        self.label_smooth_eps = label_smooth_eps
        self.loss_cls = build_loss(
            dict(loss_cls or dict(type='CrossEntropyLoss')))
        self.fc_cls = nn.Linear(in_channels, num_classes)

    def flax_init(self, generator=None):
        self.fc_cls.weight.normal_(0.0, self.init_std, generator=generator)
        self.fc_cls.bias.zero_()

    def _dropout(self, x, generator):
        if self.dropout_ratio and self.training:
            return dropout(x, self.dropout_ratio, generator)
        return x

    def loss(self, cls_score, labels):
        return head_loss(self.loss_cls, cls_score, labels, self.num_classes,
                         self.label_smooth_eps, self.multi_class)


@HEADS.register_module()
class TSNHead(_ClsHead):
    """Spatial average, average consensus over the segments, fc
    (reference tsn_head.py:9-96)."""

    def __init__(self, num_classes, in_channels, loss_cls=None,
                 spatial_type='avg', consensus=None, dropout_ratio=0.4,
                 init_std=0.01, multi_class=False, label_smooth_eps=0.0):
        super().__init__(num_classes, in_channels, loss_cls, dropout_ratio,
                         init_std, multi_class, label_smooth_eps)
        self.spatial_type = spatial_type

    def forward(self, x, num_segs: int, generator=None):
        # x: (N * num_segs, C, H, W)
        if self.spatial_type == 'avg':
            x = torch.mean(x, dim=(2, 3))
        x = torch.mean(x.reshape(-1, num_segs, x.shape[-1]), dim=1)
        return self.fc_cls(self._dropout(x, generator))


@HEADS.register_module()
class I3DHead(_ClsHead):
    """Global average over (T, H, W), fc (reference i3d_head.py:9-85)."""

    def __init__(self, num_classes, in_channels, loss_cls=None,
                 spatial_type='avg', dropout_ratio=0.5, init_std=0.01,
                 multi_class=False, label_smooth_eps=0.0):
        super().__init__(num_classes, in_channels, loss_cls, dropout_ratio,
                         init_std, multi_class, label_smooth_eps)
        self.spatial_type = spatial_type

    def forward(self, x, generator=None):
        # x: (N, C, T, H, W)
        if self.spatial_type == 'avg':
            x = torch.mean(x, dim=(2, 3, 4))
        return self.fc_cls(self._dropout(x, generator))


@HEADS.register_module()
class TSMHead(_ClsHead):
    """fc on each segment, then the average over the segments (reference
    tsm_head.py)."""

    def __init__(self, num_classes, in_channels, num_segments=8,
                 loss_cls=None, spatial_type='avg', consensus=None,
                 dropout_ratio=0.8, init_std=0.001, is_shift=True,
                 temporal_pool=False, multi_class=False,
                 label_smooth_eps=0.0):
        super().__init__(num_classes, in_channels, loss_cls, dropout_ratio,
                         init_std, multi_class, label_smooth_eps)
        self.num_segments = num_segments
        self.spatial_type = spatial_type
        self.is_shift = is_shift
        self.temporal_pool = temporal_pool

    def forward(self, x, num_segs: Optional[int] = None, generator=None):
        if self.spatial_type == 'avg' and x.dim() == 4:
            x = torch.mean(x, dim=(2, 3))
        cls_score = self.fc_cls(self._dropout(x, generator))
        segs = self.num_segments // 2 if self.temporal_pool \
            else self.num_segments
        return torch.mean(cls_score.reshape(-1, segs, self.num_classes),
                          dim=1)


@HEADS.register_module()
class SlowFastHead(_ClsHead):
    """Average-pooled pathways concatenated, fc (reference
    slowfast_head.py). The backbone yields (slow, fast); the fc sees
    [fast, slow], the order of the reference head (slowfast_head.py:64-69)
    and of the JAX package's."""

    def __init__(self, num_classes, in_channels, loss_cls=None,
                 spatial_type='avg', dropout_ratio=0.8, init_std=0.01,
                 multi_class=False, label_smooth_eps=0.0):
        super().__init__(num_classes, in_channels, loss_cls, dropout_ratio,
                         init_std, multi_class, label_smooth_eps)
        self.spatial_type = spatial_type

    def forward(self, x, generator=None):
        x_slow, x_fast = x  # each (N, C, T, H, W)
        feat = torch.cat([torch.mean(x_fast, dim=(2, 3, 4)),
                          torch.mean(x_slow, dim=(2, 3, 4))], dim=-1)
        return self.fc_cls(self._dropout(feat, generator))
