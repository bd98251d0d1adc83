"""SimSiam frame-level similarity pretraining model (counterpart of
``vfs_tpu/models/trackers/sim_siam_tracker.py``; reference:
mmaction/models/trackers/sim_siam_base_tracker.py:8-76).

Input: two augmented clips per sample, ``(B, 2, T, H, W, C)``
channels-last, as the train pipeline emits. Each view goes through the
backbone and the head on its own (so each is its own BatchNorm batch, as
in the JAX package). With ``train_cfg.intra_video`` the second view's
(z, p) are rolled over the clip axis and every shift adds a loss term, each
weighted 1 / T: the frame-level similarity of VFS.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ...utils import add_prefix
from .. import builder
from ..backbones.resnet import BasicBlock, Bottleneck
from ..common.utils import flax_default_init
from ..registry import TRACKERS


@TRACKERS.register_module()
class SimSiamBaseTracker(nn.Module):

    def __init__(self, backbone: Dict[str, Any],
                 img_head: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None):
        super().__init__()
        self.backbone = builder.build_backbone(dict(backbone))
        self.img_head = (builder.build_head(dict(img_head))
                         if img_head is not None else None)
        tc = dict(train_cfg or {})
        self.intra_video = bool(tc.get('intra_video', False))
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """The JAX package's initial weights, in distribution: flax's
        default initialisers, and each residual block's last BatchNorm
        scale 0 under ``zero_init_residual``."""
        flax_default_init(self, generator)
        if self.backbone.zero_init_residual:
            with torch.no_grad():
                for m in self.backbone.modules():
                    if isinstance(m, (BasicBlock, Bottleneck)):
                        m.last_bn.weight.zero_()

    def forward_img_head(self, x1, x2, clip_len: int) -> Dict:
        if isinstance(x1, tuple):
            x1 = x1[-1]
        if isinstance(x2, tuple):
            x2 = x2[-1]
        z1, p1 = self.img_head(x1)
        z2, p2 = self.img_head(x2)
        weight = 1.0 / clip_len if self.intra_video else 1.0
        losses = add_prefix(self.img_head.loss(p1, z1, p2, z2, weight=weight),
                            prefix='0')
        if self.intra_video:
            # (B*T, C) -> (B, T, C) for the rolls over the clip
            bt, c = z2.shape
            z2_v = z2.reshape(bt // clip_len, clip_len, c)
            p2_v = p2.reshape(bt // clip_len, clip_len, c)
            for i in range(1, clip_len):
                z2_r = torch.roll(z2_v, i, dims=1).reshape(bt, c)
                p2_r = torch.roll(p2_v, i, dims=1).reshape(bt, c)
                losses.update(add_prefix(
                    self.img_head.loss(p1, z1, p2_r, z2_r, weight=weight),
                    prefix=f'{i}'))
        return losses

    def forward(self, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """imgs (B, 2, T, H, W, C) -> the loss dict (reference forward_train,
        sim_siam_base_tracker.py:58-76); train or eval BatchNorm by the
        module's mode."""
        if imgs.dim() != 6 or imgs.shape[1] != 2:
            raise ValueError(f'imgs must be (B, 2, T, H, W, C), got '
                             f'{tuple(imgs.shape)}')
        b, _, t, h, w, c = imgs.shape
        x1 = self.backbone(imgs[:, 0].reshape(b * t, h, w, c))
        x2 = self.backbone(imgs[:, 1].reshape(b * t, h, w, c))
        if self.img_head is None:
            return {}
        return add_prefix(self.forward_img_head(x1, x2, t), prefix='img_head')


def parse_losses(losses: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total_loss, log_vars): the mean of each entry, and the sum of the
    entries whose key contains 'loss' (reference trackers/base.py:76-110).
    The log vars are this process's; ``parallel.reduce_log_vars`` averages
    them over a training run's processes."""
    log_vars = {name: torch.mean(value) for name, value in losses.items()}
    total = sum(v for k, v in log_vars.items() if 'loss' in k)
    log_vars['loss'] = total
    return total, log_vars
