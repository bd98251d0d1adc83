"""BMN and binary logistic regression losses (counterpart of
``vfs_tpu/models/losses/bmn_loss.py``; reference:
mmaction/models/losses/{bmn_loss,binary_logistic_regression_loss}.py).

The PEM regression loss samples its medium and low IoU cells with two
uniform draws of the IoU map's shape. They come from ``generator`` (a
``torch.Generator`` on the map's device; the global one when None), or,
given as ``draws = (u_m, u_l)``, are used as they are: a test feeds both
packages the same numbers that way.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..registry import LOSSES


def binary_logistic_regression_loss(reg_score, label, threshold=0.5,
                                    ratio_range=(1.05, 21), eps=1e-5):
    label = label.reshape(-1)
    reg_score = reg_score.reshape(-1)
    pmask = (label > threshold).to(reg_score.dtype)
    num_positive = torch.clamp(pmask.sum(), min=1)
    num_entries = label.shape[0]
    ratio = torch.clamp(num_entries / num_positive, ratio_range[0],
                        ratio_range[1])
    coef_0 = 0.5 * ratio / (ratio - 1)
    coef_1 = 0.5 * ratio
    loss = coef_1 * pmask * torch.log(reg_score + eps) + coef_0 * (
        1.0 - pmask) * torch.log(1.0 - reg_score + eps)
    return -loss.mean()


@LOSSES.register_module()
class BinaryLogisticRegressionLoss:

    def __call__(self, reg_score, label, threshold=0.5,
                 ratio_range=(1.05, 21), eps=1e-5):
        return binary_logistic_regression_loss(reg_score, label, threshold,
                                               ratio_range, eps)


def uniform_draws(like: torch.Tensor, generator: Optional[torch.Generator],
                  draws: Optional[Sequence[torch.Tensor]] = None):
    """Two uniform [0, 1) tensors shaped, typed and placed as ``like``:
    ``draws`` when given, else two draws from ``generator``."""
    if draws is not None:
        return tuple((d if torch.is_tensor(d) else torch.from_numpy(
            np.array(d))).to(like) for d in draws)
    return tuple(torch.rand(like.shape, generator=generator,
                            dtype=like.dtype, device=like.device)
                 for _ in range(2))


@LOSSES.register_module()
class BMNLoss:
    """Weighted sum of the TEM loss and the PEM regression and
    classification losses (reference bmn_loss.py:10-180)."""

    @staticmethod
    def tem_loss(pred_start, pred_end, gt_start, gt_end):
        return (binary_logistic_regression_loss(pred_start, gt_start) +
                binary_logistic_regression_loss(pred_end, gt_end))

    @staticmethod
    def pem_reg_loss(pred_score, gt_iou_map, mask, generator=None,
                     draws=None, high_temporal_iou_threshold=0.7,
                     low_temporal_iou_threshold=0.3):
        dtype = pred_score.dtype
        u_hmask = (gt_iou_map > high_temporal_iou_threshold).to(dtype)
        u_mmask = ((gt_iou_map <= high_temporal_iou_threshold) &
                   (gt_iou_map > low_temporal_iou_threshold)).to(dtype)
        u_lmask = ((gt_iou_map <= low_temporal_iou_threshold) &
                   (gt_iou_map > 0.0)).to(dtype) * mask
        num_h = u_hmask.sum()
        num_m = u_mmask.sum()
        num_l = u_lmask.sum()
        u_m, u_l = uniform_draws(gt_iou_map.to(dtype), generator, draws)
        r_m = num_h / torch.clamp(num_m, min=1)
        u_smmask = ((u_mmask * u_m) > (1.0 - r_m)).to(dtype)
        r_l = num_h / torch.clamp(num_l, min=1)
        u_slmask = ((u_lmask * u_l) > (1.0 - r_l)).to(dtype)
        weights = u_hmask + u_smmask + u_slmask
        mse = (pred_score * weights - gt_iou_map * weights)**2
        return 0.5 * mse.sum() / torch.clamp(weights.sum(), min=1)

    @staticmethod
    def pem_cls_loss(pred_score, gt_iou_map, mask, threshold=0.9,
                     ratio_range=(1.05, 21), eps=1e-5):
        dtype = pred_score.dtype
        pmask = (gt_iou_map > threshold).to(dtype)
        nmask = (gt_iou_map <= threshold).to(dtype) * mask
        num_positive = torch.clamp(pmask.sum(), min=1)
        num_entries = num_positive + nmask.sum()
        ratio = torch.clamp(num_entries / num_positive, ratio_range[0],
                            ratio_range[1])
        coef_0 = 0.5 * ratio / (ratio - 1)
        coef_1 = 0.5 * ratio
        loss_pos = coef_1 * torch.log(pred_score + eps) * pmask
        loss_neg = coef_0 * torch.log(1.0 - pred_score + eps) * nmask
        return -(loss_pos + loss_neg).sum() / num_entries

    def __call__(self, pred_bm, pred_start, pred_end, gt_iou_map, gt_start,
                 gt_end, bm_mask, generator=None, draws=None, weight_tem=1.0,
                 weight_pem_reg=10.0, weight_pem_cls=1.0):
        """``pred_bm`` (N, duration, start, 2) as the JAX package lays it
        out, the labels (N, T, T) / (N, T), ``bm_mask`` (T, T)."""
        pred_bm_reg = pred_bm[..., 0]
        pred_bm_cls = pred_bm[..., 1]
        gt_iou_map = gt_iou_map * bm_mask
        pem_reg_loss = self.pem_reg_loss(pred_bm_reg, gt_iou_map, bm_mask,
                                         generator, draws)
        pem_cls_loss = self.pem_cls_loss(pred_bm_cls, gt_iou_map, bm_mask)
        tem_loss = self.tem_loss(pred_start, pred_end, gt_start, gt_end)
        loss = (weight_tem * tem_loss + weight_pem_reg * pem_reg_loss +
                weight_pem_cls * pem_cls_loss)
        return loss, tem_loss, pem_reg_loss, pem_cls_loss
