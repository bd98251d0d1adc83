"""Classification and regression losses (counterpart of
``vfs_tpu/models/losses/regression.py``; reference:
mmaction/models/losses/{cross_entropy_loss,nll_loss,hvu_loss}.py and
smooth_l1). Scores are ``(N, classes)``; each loss is the batch mean times
``loss_weight``."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import LOSSES


@LOSSES.register_module()
class CrossEntropyLoss:
    """Hard labels ``(N,)`` (class indices) or soft labels ``(N,
    classes)``, told apart by their rank."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label):
        lsm = F.log_softmax(cls_score, dim=-1)
        if label.dim() == cls_score.dim():  # soft labels
            loss = -torch.sum(label * lsm, dim=-1).mean()
        else:
            loss = -torch.gather(lsm, -1, label.long()[..., None]).mean()
        return loss * self.loss_weight


@LOSSES.register_module()
class BCELossWithLogits:

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label):
        log_p = F.logsigmoid(cls_score)
        log_not_p = F.logsigmoid(-cls_score)
        loss = -(label * log_p + (1 - label) * log_not_p).mean()
        return loss * self.loss_weight


@LOSSES.register_module()
class NLLLoss:
    """``cls_score`` holds log-probabilities."""

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, cls_score, label):
        loss = -torch.gather(cls_score, -1, label.long()[..., None]).mean()
        return loss * self.loss_weight


@LOSSES.register_module()
class MSELoss:

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, pred, target):
        return torch.mean((pred - target)**2) * self.loss_weight


@LOSSES.register_module()
class L1Loss:

    def __init__(self, loss_weight=1.0):
        self.loss_weight = loss_weight

    def __call__(self, pred, target):
        return torch.mean(torch.abs(pred - target)) * self.loss_weight


@LOSSES.register_module()
class SmoothL1Loss:

    def __init__(self, beta=1.0, loss_weight=1.0):
        self.beta = beta
        self.loss_weight = loss_weight

    def __call__(self, pred, target):
        diff = torch.abs(pred - target)
        loss = torch.where(diff < self.beta, 0.5 * diff**2 / self.beta,
                           diff - 0.5 * self.beta)
        return torch.mean(loss) * self.loss_weight
