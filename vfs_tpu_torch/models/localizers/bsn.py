"""BSN's temporal and proposal evaluation models (counterpart of
``vfs_tpu/models/localizers/bsn.py``; reference:
mmaction/models/localizers/bsn.py:14-430).

``TEM`` keeps the JAX seam, ``(N, T, feat_dim)`` in and ``(N, T, 3)``
(action, start, end) out, with channels-first 1-D convolutions inside and
the JAX module's output ratios (``conv3_ratio=0.01``). ``PEM`` scores
``(M, feat_dim)`` BSP features; its loss samples the medium and low IoU
proposals with two uniform draws from ``generator`` or, given as
``draws``, with those (``losses.bmn_loss.uniform_draws``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...localization import temporal_iop
from ..builder import build_loss
from ..common.utils import flax_module_init
from ..losses.bmn_loss import uniform_draws
from ..registry import LOCALIZERS


@LOCALIZERS.register_module()
class TEM(nn.Module):
    """Temporal Evaluation Model: three 1-D convolutions, then sigmoid
    (action, start, end) scores a position."""

    def __init__(self, temporal_dim, boundary_ratio, tem_feat_dim,
                 tem_hidden_dim, tem_match_threshold, loss_cls: Any = None,
                 loss_weight=2.0, output_dim=3, conv1_ratio=1.0,
                 conv2_ratio=1.0, conv3_ratio=0.01,
                 train_cfg: Optional[Any] = None,
                 test_cfg: Optional[Any] = None):
        super().__init__()
        self.temporal_dim = temporal_dim
        self.boundary_ratio = boundary_ratio
        self.tem_match_threshold = tem_match_threshold
        self.loss_weight = loss_weight
        self.conv1_ratio = conv1_ratio
        self.conv2_ratio = conv2_ratio
        self.conv3_ratio = conv3_ratio
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self._loss = build_loss(dict(
            loss_cls or dict(type='BinaryLogisticRegressionLoss')))
        self.conv1 = nn.Conv1d(tem_feat_dim, tem_hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv1d(tem_hidden_dim, tem_hidden_dim, 3, padding=1)
        self.conv3 = nn.Conv1d(tem_hidden_dim, output_dim, 1)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        flax_module_init(self, generator)

    def forward(self, raw_feature):
        """``raw_feature`` (N, T, feat_dim) -> (N, T, 3) sigmoid scores."""
        x = raw_feature.transpose(1, 2)
        x = F.relu(self.conv1_ratio * self.conv1(x))
        x = F.relu(self.conv2_ratio * self.conv2(x))
        x = torch.sigmoid(self.conv3_ratio * self.conv3(x))
        return x.transpose(1, 2)

    def loss(self, tem_output, label_action, label_start, label_end):
        """Weighted BLR losses on action/start/end (reference :120-140)."""
        loss_action = self._loss(tem_output[..., 0], label_action,
                                 self.tem_match_threshold)
        loss_start = self._loss(tem_output[..., 1], label_start,
                                self.tem_match_threshold)
        loss_end = self._loss(tem_output[..., 2], label_end,
                              self.tem_match_threshold)
        return dict(loss_action=loss_action * self.loss_weight,
                    loss_start=loss_start, loss_end=loss_end)

    def generate_labels(self, gt_bbox):
        """Anchor-overlap labels (reference bsn.py:162-226), numpy."""
        tscale = self.temporal_dim
        gap = 1.0 / tscale
        anchors_tmins = np.array([gap * i for i in range(tscale)])
        anchors_tmaxs = anchors_tmins + gap
        match_score_action_list = []
        match_score_start_list = []
        match_score_end_list = []
        for every_gt_bbox in gt_bbox:
            every_gt_bbox = np.asarray(every_gt_bbox)
            gt_tmins = every_gt_bbox[:, 0]
            gt_tmaxs = every_gt_bbox[:, 1]
            gt_lens = gt_tmaxs - gt_tmins
            gt_len_pad = np.maximum(gap, self.boundary_ratio * gt_lens)
            gt_start_bboxs = np.stack(
                (gt_tmins - gt_len_pad / 2, gt_tmins + gt_len_pad / 2),
                axis=1)
            gt_end_bboxs = np.stack(
                (gt_tmaxs - gt_len_pad / 2, gt_tmaxs + gt_len_pad / 2),
                axis=1)
            ms_action, ms_start, ms_end = [], [], []
            for tmin, tmax in zip(anchors_tmins, anchors_tmaxs):
                ms_action.append(np.max(
                    temporal_iop(tmin, tmax, gt_tmins, gt_tmaxs)))
                ms_start.append(np.max(temporal_iop(
                    tmin, tmax, gt_start_bboxs[:, 0], gt_start_bboxs[:, 1])))
                ms_end.append(np.max(temporal_iop(
                    tmin, tmax, gt_end_bboxs[:, 0], gt_end_bboxs[:, 1])))
            match_score_action_list.append(ms_action)
            match_score_start_list.append(ms_start)
            match_score_end_list.append(ms_end)
        return (np.array(match_score_action_list, np.float32),
                np.array(match_score_start_list, np.float32),
                np.array(match_score_end_list, np.float32))


@LOCALIZERS.register_module()
class PEM(nn.Module):
    """Proposal Evaluation Model: two linear layers scoring BSP
    features."""

    def __init__(self, pem_feat_dim, pem_hidden_dim, pem_u_ratio_m,
                 pem_u_ratio_l, pem_high_temporal_iou_threshold,
                 pem_low_temporal_iou_threshold, soft_nms_alpha,
                 soft_nms_low_threshold, soft_nms_high_threshold,
                 post_process_top_k, fc1_ratio=0.1, fc2_ratio=0.1,
                 output_dim=1, train_cfg: Optional[Any] = None,
                 test_cfg: Optional[Any] = None):
        super().__init__()
        self.pem_u_ratio_m = pem_u_ratio_m
        self.pem_u_ratio_l = pem_u_ratio_l
        self.pem_high_temporal_iou_threshold = pem_high_temporal_iou_threshold
        self.pem_low_temporal_iou_threshold = pem_low_temporal_iou_threshold
        self.soft_nms_alpha = soft_nms_alpha
        self.soft_nms_low_threshold = soft_nms_low_threshold
        self.soft_nms_high_threshold = soft_nms_high_threshold
        self.post_process_top_k = post_process_top_k
        self.fc1_ratio = fc1_ratio
        self.fc2_ratio = fc2_ratio
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.fc1 = nn.Linear(pem_feat_dim, pem_hidden_dim)
        self.fc2 = nn.Linear(pem_hidden_dim, output_dim)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        flax_module_init(self, generator)

    def forward(self, bsp_feature):
        """``bsp_feature`` (M, feat_dim) -> (M, output_dim) sigmoid
        scores."""
        x = F.relu(self.fc1_ratio * self.fc1(bsp_feature))
        return torch.sigmoid(self.fc2_ratio * self.fc2(x))

    def loss(self, pem_output, reference_temporal_iou, generator=None,
             draws=None):
        """Hard-sample-balanced MSE (reference bsn.py:305-348)."""
        pred = pem_output.reshape(-1)
        ref = reference_temporal_iou.reshape(-1).to(pred.dtype)
        high = self.pem_high_temporal_iou_threshold
        low = self.pem_low_temporal_iou_threshold
        u_hmask = (ref > high).to(pred.dtype)
        u_mmask = ((ref <= high) & (ref > low)).to(pred.dtype)
        u_lmask = (ref <= low).to(pred.dtype)
        num_h = u_hmask.sum()
        num_m = u_mmask.sum()
        num_l = u_lmask.sum()
        u_m, u_l = uniform_draws(ref, generator, draws)
        r_m = torch.clamp(self.pem_u_ratio_m * num_h /
                          torch.clamp(num_m, min=1), max=1.0)
        u_smmask = ((u_mmask * u_m) > (1.0 - r_m)).to(pred.dtype)
        r_l = torch.clamp(self.pem_u_ratio_l * num_h /
                          torch.clamp(num_l, min=1), max=1.0)
        u_slmask = ((u_lmask * u_l) > (1.0 - r_l)).to(pred.dtype)
        weights = u_hmask + u_smmask + u_slmask
        loss = ((pred - ref)**2) * weights
        return dict(temporal_iou_loss=0.5 * loss.sum() /
                    torch.clamp(weights.sum(), min=1))
