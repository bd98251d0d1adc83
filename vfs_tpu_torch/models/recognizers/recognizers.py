"""Action recognizers (counterpart of
``vfs_tpu/models/recognizers/recognizers.py``; reference:
mmaction/models/recognizers/{base,recognizer2d,recognizer3d}.py).

The entry keeps the JAX package's channels-last contract, which the
pipeline's ``FormatShape`` yields: ``Recognizer2D`` takes (N, segments, H,
W, C) and ``Recognizer3D`` (N, clips, T, H, W, C). The recognizer folds
the segments or clips into the batch and permutes once to NCHW / NCTHW (a
view: on the card the tensor keeps its channels-last memory, which cuDNN
reads as such); the backbones and heads work in that layout. The port's
``ResNet`` keeps its own NHWC seam, so a 2-D recognizer over it hands it
the frames as they come and permutes its maps.

``forward(imgs, labels, return_loss=True)`` returns the head's loss dict;
with ``return_loss=False`` the clip scores, averaged as
``test_cfg.average_clips`` says (base.py:58-84). ``generator`` feeds the
head's dropout in training mode.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .. import builder
from ..backbones.resnet import ResNet
from ..common.utils import flax_module_init
from ..registry import RECOGNIZERS


class BaseRecognizer(nn.Module):

    def __init__(self, backbone, cls_head, train_cfg=None, test_cfg=None):
        super().__init__()
        self.backbone = builder.build_backbone(dict(backbone))
        self.cls_head = builder.build_head(dict(cls_head))
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX modules' initialisers (``flax_module_init``); the port's
        ``ResNet`` inside takes the JAX ``ResNet``'s, whose last BatchNorm
        of each block starts at zero under ``zero_init_residual``."""
        flax_module_init(self, generator)
        if isinstance(self.backbone, ResNet) \
                and self.backbone.zero_init_residual:
            for m in self.backbone.modules():
                if hasattr(m, 'last_bn'):
                    m.last_bn.weight.data.zero_()

    def average_clip(self, cls_score):
        """Reference base.py:58-84."""
        average_clips = dict(self.test_cfg or {}).get('average_clips')
        if average_clips not in ('score', 'prob', None):
            raise ValueError(f'{average_clips} is not supported')
        if average_clips == 'prob':
            return torch.mean(torch.softmax(cls_score, dim=1), dim=0,
                              keepdim=True)
        if average_clips == 'score':
            return torch.mean(cls_score, dim=0, keepdim=True)
        return cls_score

    def _result(self, cls_score, labels, return_loss):
        if return_loss:
            if labels is None:
                raise ValueError('a loss needs labels')
            return self.cls_head.loss(cls_score, labels.reshape(-1))
        return self.average_clip(cls_score)


@RECOGNIZERS.register_module()
class Recognizer2D(BaseRecognizer):
    """Segments become batch rows; the head takes per-segment maps
    (reference recognizer2d.py)."""

    def forward(self, imgs, labels=None, return_loss: bool = True,
                generator: Optional[torch.Generator] = None):
        batches = imgs.shape[0]
        x = imgs.reshape(-1, *imgs.shape[2:])  # (N * segs, H, W, C)
        num_segs = x.shape[0] // batches
        if isinstance(self.backbone, ResNet):
            x = self.backbone(x)
            x = (x[-1] if isinstance(x, tuple) else x).permute(0, 3, 1, 2)
        else:
            x = self.backbone(x.permute(0, 3, 1, 2))
            x = x[-1] if isinstance(x, tuple) else x
        cls_score = self.cls_head(x, num_segs, generator=generator)
        return self._result(cls_score, labels, return_loss)


@RECOGNIZERS.register_module()
class Recognizer3D(BaseRecognizer):
    """Clips become batch rows; the head takes (N, C, T, H, W) maps
    (reference recognizer3d.py)."""

    def forward(self, imgs, labels=None, return_loss: bool = True,
                generator: Optional[torch.Generator] = None):
        x = imgs.reshape(-1, *imgs.shape[2:])  # (N * clips, T, H, W, C)
        x = self.backbone(x.permute(0, 4, 1, 2, 3))
        cls_score = self.cls_head(x, generator=generator)
        return self._result(cls_score, labels, return_loss)
