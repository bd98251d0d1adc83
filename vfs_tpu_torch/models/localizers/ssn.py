"""SSN temporal action detector (counterpart of
``vfs_tpu/models/localizers/ssn.py``; reference:
mmaction/models/localizers/ssn.py:10-129).

Training: the backbone over every sampled segment, a global spatial pool,
``SSNHead`` (``STPPTrain``) and ``SSNLoss``. ``forward(...,
return_loss=False)`` returns the pooled per-segment features, as in the
JAX package. ``forward_test`` is the reference's test path: the frames in
chunks through the backbone, ``SSNHead.test_fc`` a frame, then the
host-side ``STPPTest`` over each proposal's ticks and the regression's
normalisation undone.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn

from .. import builder
from ..backbones.resnet import ResNet
from ..common.utils import flax_module_init
from ..heads.ssn_head import STPPTest
from ..registry import LOCALIZERS


@LOCALIZERS.register_module()
class SSN(nn.Module):

    def __init__(self, backbone, cls_head, in_channels=3,
                 spatial_type='avg', dropout_ratio=0.5, loss_cls: Any = None,
                 train_cfg: Optional[Any] = None,
                 test_cfg: Optional[Any] = None):
        super().__init__()
        self.backbone = builder.build_backbone(dict(backbone))
        self.cls_head = builder.build_head(dict(cls_head))
        self.loss_cls = builder.build_loss(
            dict(loss_cls or dict(type='SSNLoss')))
        self.spatial_type = spatial_type
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX modules' initialisers (as the recognizers take them)."""
        flax_module_init(self, generator)
        if isinstance(self.backbone, ResNet) \
                and self.backbone.zero_init_residual:
            for m in self.backbone.modules():
                if hasattr(m, 'last_bn'):
                    m.last_bn.weight.data.zero_()

    def extract_feat(self, imgs):
        """(M, H, W, C) frames -> (M, C') globally pooled features."""
        x = self.backbone(imgs)
        if isinstance(x, tuple):
            x = x[-1]
        if self.spatial_type == 'avg':
            x = x.mean(dim=(1, 2))
        elif self.spatial_type == 'max':
            x = x.amax(dim=(1, 2))
        return x

    def forward(self, imgs, proposal_scale_factor=None, proposal_type=None,
                proposal_labels=None, reg_targets=None,
                return_loss: bool = True,
                generator: Optional[torch.Generator] = None):
        """Train: ``imgs`` (N, proposals * segments, H, W, C) -> the loss
        dict (``generator`` feeds the head's dropout). With
        ``return_loss=False``: the pooled per-segment features."""
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[-3:]))
        x = self.extract_feat(imgs)
        if not return_loss:
            return x
        activity, completeness, bbox_preds = self.cls_head(
            x, proposal_scale_factor, generator)
        return self.loss_cls(activity, completeness, bbox_preds,
                             proposal_type, proposal_labels, reg_targets,
                             self.train_cfg)

    @torch.no_grad()
    def forward_test(self, imgs, relative_proposal_list, scale_factor_list,
                     proposal_tick_list, reg_norm_consts):
        """One video's test frames (frames, H, W, C) and its proposals
        (``SSNDataset.prepare_test_frames``) -> ``(relative proposals,
        activity, completeness, regression)`` as numpy, the tuple
        ``SSNDataset.evaluate`` takes (reference ssn.py:79-129). The
        frames go through the backbone ``test_cfg.ssn.sampler.batch_size``
        at a time."""
        head = self.cls_head
        chunk = int(dict(dict(self.test_cfg or {}).get('ssn', {})
                         .get('sampler', {})).get('batch_size', 16))
        imgs = imgs.reshape((-1,) + tuple(imgs.shape[-3:]))
        scores = torch.cat([head.test_fc(self.extract_feat(imgs[i:i + chunk]))
                            for i in range(0, imgs.shape[0], chunk)])
        stpp = STPPTest(head.num_classes, head.use_regression, head.stpp_cfg)
        activity, completeness, bbox = stpp(
            scores.cpu().numpy(), np.asarray(proposal_tick_list),
            np.asarray(scale_factor_list))
        if bbox is not None:
            consts = np.asarray(reg_norm_consts)
            bbox = bbox.reshape(-1, head.num_classes, 2)
            bbox = bbox * consts[1][None, None] + consts[0][None, None]
        return (np.asarray(relative_proposal_list), activity, completeness,
                bbox)
