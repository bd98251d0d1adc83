"""SSN losses: the OHEM hinge loss and the activity, completeness and
regression terms (counterpart of ``vfs_tpu/models/losses/ssn_loss.py``;
reference: mmaction/models/losses/{ohem_hinge_loss,ssn_loss}.py).

The OHEM hinge loss is a ``torch.autograd.Function`` with the JAX
package's hand-written backward (its ``jax.custom_vjp``): only the kept
hard examples take a gradient, on their label's column, each
``slope * g / (groups * kept)``. Ties among the hinge losses (rows at
exactly 0 are common) keep the lowest index first: a stable sort of the
negated losses, as ``jnp.argsort`` sorts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import LOSSES


class _OHEMHinge(torch.autograd.Function):

    @staticmethod
    def forward(ctx, pred, labels, is_positive, ohem_ratio, group_size):
        class_pred = pred.gather(1, (labels - 1)[:, None])[:, 0]
        losses = torch.clamp(1.0 - is_positive * class_pred, min=0.0)
        slopes = torch.where(losses != 0, -float(is_positive), 0.0).to(
            pred.dtype)
        grouped = losses.reshape(-1, group_size)
        keep_length = int(group_size * ohem_ratio)
        neg_sorted, sort_idx = torch.sort(-grouped, dim=1, stable=True)
        loss = (-neg_sorted[:, :keep_length]).sum()
        ctx.save_for_backward(slopes, sort_idx[:, :keep_length], labels)
        ctx.pred_shape = pred.shape
        ctx.group_size = group_size
        return loss

    @staticmethod
    def backward(ctx, g):
        slopes, keep_idx, labels = ctx.saved_tensors
        num_groups, keep_len = keep_idx.shape
        grad = torch.zeros(ctx.pred_shape, dtype=g.dtype, device=g.device)
        group_ids = torch.arange(num_groups, device=g.device
                                 ).repeat_interleave(keep_len)
        rows = group_ids * ctx.group_size + keep_idx.reshape(-1)
        cols = labels[rows] - 1
        vals = slopes[rows] * g / float(num_groups * keep_len)
        grad.index_put_((rows, cols), vals, accumulate=True)
        return grad, None, None, None, None


def ohem_hinge_loss(pred, labels, is_positive, ohem_ratio, group_size):
    """The summed hinge losses of the ``ohem_ratio`` hardest rows of each
    group of ``group_size`` (``labels`` 1-based class indices)."""
    return _OHEMHinge.apply(pred, labels, is_positive, ohem_ratio,
                            group_size)


@LOSSES.register_module()
class OHEMHingeLoss:
    """Functional wrapper (reference ohem_hinge_loss.py:4-80)."""

    def __call__(self, pred, labels, is_positive, ohem_ratio, group_size):
        return ohem_hinge_loss(pred, labels, is_positive, ohem_ratio,
                               group_size)


def _indexer(cond: torch.Tensor, size: int) -> torch.Tensor:
    """``jnp.nonzero(cond, size=size)[0]``: the true positions in order,
    cut to ``size`` or padded with index 0."""
    idx = torch.nonzero(cond).flatten()[:size]
    if idx.numel() < size:
        idx = torch.cat([idx, idx.new_zeros(size - idx.numel())])
    return idx


@LOSSES.register_module()
class SSNLoss:
    """Activity cross-entropy, OHEM completeness and class-wise smooth-L1
    regression (reference ssn_loss.py:10-186)."""

    @staticmethod
    def activity_loss(activity_score, labels, activity_indexer):
        sel_score = activity_score[activity_indexer]
        sel_labels = labels[activity_indexer]
        lsm = F.log_softmax(sel_score, dim=-1)
        return -lsm.gather(1, sel_labels[:, None]).mean()

    @staticmethod
    def completeness_loss(completeness_score, labels, completeness_indexer,
                          positive_per_video, incomplete_per_video,
                          ohem_ratio):
        pred = completeness_score[completeness_indexer]
        gt = labels[completeness_indexer]
        pred_dim = pred.shape[1]
        per_video = positive_per_video + incomplete_per_video
        pred = pred.reshape(-1, per_video, pred_dim)
        gt = gt.reshape(-1, per_video)
        pos_pred = pred[:, :positive_per_video].reshape(-1, pred_dim)
        pos_gt = gt[:, :positive_per_video].reshape(-1)
        inc_pred = pred[:, positive_per_video:].reshape(-1, pred_dim)
        inc_gt = gt[:, positive_per_video:].reshape(-1)
        pos_loss = ohem_hinge_loss(pos_pred, pos_gt, 1, 1.0,
                                   positive_per_video)
        inc_loss = ohem_hinge_loss(inc_pred, inc_gt, -1, ohem_ratio,
                                   incomplete_per_video)
        num_pos = pos_pred.shape[0]
        num_inc = int(inc_pred.shape[0] * ohem_ratio)
        return (pos_loss + inc_loss) / float(max(num_pos + num_inc, 1))

    @staticmethod
    def classwise_regression_loss(bbox_pred, labels, bbox_targets,
                                  regression_indexer):
        pred = bbox_pred[regression_indexer]
        gt = labels[regression_indexer]
        reg_target = bbox_targets[regression_indexer]
        classwise_pred = pred[torch.arange(pred.shape[0],
                                           device=pred.device), gt - 1]
        diff = torch.abs(classwise_pred - reg_target)
        loss = torch.where(diff < 1.0, 0.5 * diff**2, diff - 0.5)
        return loss.sum(dim=-1).mean()

    def __call__(self, activity_score, completeness_score, bbox_pred,
                 proposal_type, labels, bbox_targets, train_cfg):
        sampler = train_cfg['ssn']['sampler']
        loss_weight = train_cfg['ssn']['loss_weight']
        proposal_type = proposal_type.reshape(-1)
        labels = labels.reshape(-1)
        total_ratio = (sampler['positive_ratio'] +
                       sampler['background_ratio'] +
                       sampler['incomplete_ratio'])
        positive_per_video = int(sampler['num_per_video'] *
                                 (sampler['positive_ratio'] / total_ratio))
        background_per_video = int(
            sampler['num_per_video'] *
            (sampler['background_ratio'] / total_ratio))
        incomplete_per_video = (sampler['num_per_video'] -
                                positive_per_video - background_per_video)
        # the sampler's fixed layout a video (positives, incompletes,
        # backgrounds) gives the indexers their sizes, as in the JAX loss
        num_videos = proposal_type.shape[0] // sampler['num_per_video']
        activity_indexer = _indexer(
            (proposal_type == 0) | (proposal_type == 2),
            num_videos * (positive_per_video + background_per_video))
        completeness_indexer = _indexer(
            (proposal_type == 0) | (proposal_type == 1),
            num_videos * (positive_per_video + incomplete_per_video))
        losses = {}
        losses['loss_activity'] = self.activity_loss(
            activity_score, labels, activity_indexer)
        losses['loss_completeness'] = self.completeness_loss(
            completeness_score, labels, completeness_indexer,
            positive_per_video, incomplete_per_video,
            ohem_ratio=positive_per_video / incomplete_per_video) * \
            loss_weight['comp_loss_weight']
        if bbox_pred is not None:
            regression_indexer = _indexer(
                proposal_type == 0, num_videos * positive_per_video)
            bbox_targets = bbox_targets.reshape(-1, 2)
            losses['loss_reg'] = self.classwise_regression_loss(
                bbox_pred, labels, bbox_targets, regression_indexer) * \
                loss_weight['reg_loss_weight']
        return losses
