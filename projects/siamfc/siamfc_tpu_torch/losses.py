"""SiamFC tracking losses (PyTorch counterpart of ``siamfc_tpu/losses.py``;
reference: projects/siamfc-pytorch/siamfc/losses.py:24-131), as functions
on tensors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _bce(logits, target):
    return -(target * F.logsigmoid(logits)
             + (1 - target) * F.logsigmoid(-logits))


def balanced_loss(logits: torch.Tensor, target: torch.Tensor,
                  neg_weight: float = 1.0) -> torch.Tensor:
    """Pos/neg-balanced BCE-with-logits, weights normalized to sum 1
    (reference :24-41). Targets in {0, 0.5, 1}; 0.5 gets zero weight."""
    pos = (target == 1).to(logits.dtype)
    neg = (target == 0).to(logits.dtype)
    weight = pos / pos.sum().clamp(min=1) \
        + neg / neg.sum().clamp(min=1) * neg_weight
    weight = weight / weight.sum()
    return (_bce(logits, target) * weight).sum()


def focal_loss(logits: torch.Tensor, target: torch.Tensor,
               gamma: float = 2.0) -> torch.Tensor:
    """Numerically-stable focal BCE with the reference's mean-weight
    normalization (reference :44-66)."""
    prob = torch.sigmoid(logits)
    pos_weight = (1 - prob)**gamma
    neg_weight = prob**gamma
    loss = -(target * pos_weight * F.logsigmoid(logits) +
             (1 - target) * neg_weight * F.logsigmoid(-logits))
    avg_weight = target * pos_weight + (1 - target) * neg_weight
    return (loss / avg_weight.mean()).mean()


def ohnm_loss(logits: torch.Tensor, target: torch.Tensor,
              neg_ratio: float = 3.0, max_pos: int = 256) -> torch.Tensor:
    """Online hard negative mining BCE (reference :107-131), the JAX
    package's variant: positives weigh fully, and the negatives whose
    logit reaches the ``neg_ratio * #pos``-th largest negative logit."""
    pos = target > 0
    neg = target == 0
    neg_num = (pos.sum() * neg_ratio).to(torch.int32)
    flat = torch.where(neg, logits, torch.full_like(logits, -torch.inf))
    sorted_desc = torch.sort(flat.reshape(-1), descending=True).values
    idx = neg_num.sub(1).clamp(0, sorted_desc.numel() - 1).long()
    hard_neg = neg & (logits >= sorted_desc[idx])
    sel = (pos | hard_neg).to(logits.dtype)
    return (_bce(logits, target) * sel).sum() / sel.sum().clamp(min=1)


def create_labels(response_hw, r_pos: float, r_neg: float,
                  total_stride: int) -> np.ndarray:
    """Logistic labels from block distance (reference
    siamfc_tracker_base.py:469-500): 1 within r_pos/stride, 0.5 within
    r_neg/stride, else 0."""
    h, w = response_hw
    x = np.arange(w) - (w - 1) / 2
    y = np.arange(h) - (h - 1) / 2
    xx, yy = np.meshgrid(x, y)
    dist = np.abs(xx) + np.abs(yy)
    rp = r_pos / total_stride
    rn = r_neg / total_stride
    labels = np.where(dist <= rp, 1.0, np.where(dist < rn, 0.5, 0.0))
    return labels.astype(np.float32)


def ghmc_loss(logits: torch.Tensor, target: torch.Tensor, bins: int = 30
              ) -> torch.Tensor:
    """Gradient-harmonizing BCE (reference losses.py:69-105), the JAX
    package's stateless variant: the density is computed per batch."""
    g = (torch.sigmoid(logits) - target).abs()
    tot = logits.numel()
    which = (g * bins).to(torch.int32).clamp(0, bins - 1).long()
    counts = torch.bincount(which.reshape(-1), minlength=bins).to(
        logits.dtype)
    density = counts[which]
    weights = torch.where(density > 0, tot / density.clamp(min=1.0),
                          torch.zeros_like(density))
    weights = weights / weights.mean().clamp(min=1e-12)
    return (_bce(logits, target) * weights).sum() / tot
