"""Similarity losses (counterpart of ``vfs_tpu/models/losses/sim_loss.py``;
reference: mmaction/models/losses/sim_loss.py:8-63).

Channels-last: ``(N, C)`` pooled features or ``(N, H, W, C)`` maps.
``loss_weight`` mirrors BaseWeightedLoss (reference losses/base.py:6-37).
"""

from __future__ import annotations

import torch

from ...ops.affinity import l2_normalize
from ..registry import LOSSES


def _pairwise(cls_score: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """(N, ..., C) x (N, ..., C) -> (N, I, J) products of every position of
    ``cls_score`` with every position of ``label``."""
    n = cls_score.shape[0]
    s = cls_score.reshape(n, -1, cls_score.shape[-1])
    t = label.reshape(n, -1, label.shape[-1])
    return torch.einsum('nic,njc->nij', s, t)


@LOSSES.register_module()
class CosineSimLoss:
    """``2 - 2 * cos(p, z)`` per sample (``-cos`` when ``negative``) over
    feature-normalised inputs; ``pairwise`` takes every pair of positions,
    optionally masked."""

    def __init__(self, with_norm=True, negative=False, pairwise=False,
                 loss_weight=1.0):
        self.with_norm = with_norm
        self.negative = negative
        self.pairwise = pairwise
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label, mask=None):
        if self.with_norm:
            cls_score = l2_normalize(cls_score, dim=-1)
            label = l2_normalize(label, dim=-1)
        if mask is not None and not self.pairwise:
            raise ValueError('a mask needs pairwise=True')
        if self.pairwise:
            prod = _pairwise(cls_score, label)
            if mask is not None:
                prod = prod * mask.to(prod.dtype)
            prod = prod.reshape(prod.shape[0], -1)
        else:
            prod = torch.sum(cls_score * label, dim=-1).reshape(
                cls_score.shape[0], -1)
        if self.negative:
            loss = -torch.mean(prod, dim=-1)
        else:
            loss = 2 - 2 * torch.mean(prod, dim=-1)
        return loss * self.loss_weight


@LOSSES.register_module()
class DotSimLoss:
    """Negative mean dot product over every pair of positions (reference
    sim_loss.py:8-22)."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label):
        return -torch.mean(_pairwise(cls_score, label)) * self.loss_weight
