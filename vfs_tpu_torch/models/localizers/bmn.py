"""BMN temporal action proposal localizer (counterpart of
``vfs_tpu/models/localizers/bmn.py``; reference:
mmaction/models/localizers/bmn.py:15-470).

The seam keeps the JAX layout: ``forward`` takes ``(N, tscale, feat_dim)``
features and returns the confidence map ``(N, duration, start, 2)`` with
the start and end curves ``(N, tscale)``; ``loss`` and
``decode_proposals`` read the map in that orientation. Inside, the
convolutions run channels-first. The boundary-matching layer is one
``torch.matmul`` of the ``(N, C, T)`` features with the constant sampling
mask ``(T, S * T * T)``, whose columns are ordered (sample, duration,
start): its output is ``(N, C, S, duration, start)`` as it lies, and
``x3dp`` is a ``Conv3d`` with an ``(S, 1, 1)`` kernel over it. The mask
is built once per ``(T, S, bins, ratio)`` on the host (``get_interp1d_mask``
keeps it) and sits on the module's device as a buffer kept out of the
state dict.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ...localization import post_processing, temporal_iop, temporal_iou
from ..builder import build_loss
from ..common.utils import flax_module_init
from ..registry import LOCALIZERS


@functools.lru_cache(maxsize=4)
def get_interp1d_mask(tscale, num_samples, num_samples_per_bin,
                      boundary_ratio):
    """Sample-mask constant (reference bmn.py:352-430), shape (tscale,
    num_samples * tscale * tscale), read-only: one copy a configuration
    per process."""

    def bin_mask(seg_tmin, seg_tmax):
        plen = float(seg_tmax - seg_tmin)
        plen_sample = plen / (num_samples * num_samples_per_bin - 1.0)
        total = [seg_tmin + plen_sample * i
                 for i in range(num_samples * num_samples_per_bin)]
        p_mask = []
        for idx in range(num_samples):
            samples = total[idx * num_samples_per_bin:(idx + 1) *
                            num_samples_per_bin]
            vec = np.zeros(tscale)
            for s in samples:
                s_upper = math.ceil(s)
                s_decimal, s_down = math.modf(s)
                if 0 <= int(s_down) <= tscale - 1:
                    vec[int(s_down)] += 1 - s_decimal
                if 0 <= int(s_upper) <= tscale - 1:
                    vec[int(s_upper)] += s_decimal
            p_mask.append(vec / num_samples_per_bin)
        return np.stack(p_mask, axis=1)

    mask_mat = []
    for start_index in range(tscale):
        row = []
        for duration_index in range(tscale):
            if start_index + duration_index < tscale:
                p_tmin = start_index
                p_tmax = start_index + duration_index
                center_len = float(p_tmax - p_tmin) + 1
                row.append(bin_mask(p_tmin - center_len * boundary_ratio,
                                    p_tmax + center_len * boundary_ratio))
            else:
                row.append(np.zeros([tscale, num_samples]))
        mask_mat.append(np.stack(row, axis=2))
    mask_mat = np.stack(mask_mat, axis=3).astype(np.float32)
    mask = mask_mat.reshape(tscale, -1)
    mask.setflags(write=False)
    return mask


@LOCALIZERS.register_module()
class BMN(nn.Module):

    def __init__(self, temporal_dim, boundary_ratio, num_samples,
                 num_samples_per_bin, feat_dim, soft_nms_alpha,
                 soft_nms_low_threshold, soft_nms_high_threshold,
                 post_process_top_k, loss_cls: Any = None,
                 hidden_dim_1d=256, hidden_dim_2d=128, hidden_dim_3d=512,
                 train_cfg: Optional[Any] = None,
                 test_cfg: Optional[Any] = None):
        super().__init__()
        self.temporal_dim = temporal_dim
        self.boundary_ratio = boundary_ratio
        self.num_samples = num_samples
        self.num_samples_per_bin = num_samples_per_bin
        self.feat_dim = feat_dim
        self.soft_nms_alpha = soft_nms_alpha
        self.soft_nms_low_threshold = soft_nms_low_threshold
        self.soft_nms_high_threshold = soft_nms_high_threshold
        self.post_process_top_k = post_process_top_k
        self.hidden_dim_1d = hidden_dim_1d
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self._loss = build_loss(dict(loss_cls or dict(type='BMNLoss')))
        h1, h2, h3 = hidden_dim_1d, hidden_dim_2d, hidden_dim_3d

        def conv1d(cin, cout, k, groups=1):
            return nn.Conv1d(cin, cout, k, padding=k // 2, groups=groups)

        self.x1db_0 = conv1d(feat_dim, h1, 3, groups=4)
        self.x1db_1 = conv1d(h1, h1, 3, groups=4)
        self.x1ds_0 = conv1d(h1, h1, 3, groups=4)
        self.x1ds_1 = conv1d(h1, 1, 1)
        self.x1de_0 = conv1d(h1, h1, 3, groups=4)
        self.x1de_1 = conv1d(h1, 1, 1)
        self.x1dp_0 = conv1d(h1, h1, 3)
        self.x3dp = nn.Conv3d(h1, h3, (num_samples, 1, 1))
        self.x2dp_0 = nn.Conv2d(h3, h2, 1)
        self.x2dp_1 = nn.Conv2d(h2, h2, 3, padding=1)
        self.x2dp_2 = nn.Conv2d(h2, h2, 3, padding=1)
        self.x2dp_3 = nn.Conv2d(h2, 2, 1)
        mask = get_interp1d_mask(temporal_dim, num_samples,
                                 num_samples_per_bin, boundary_ratio)
        self.register_buffer('sample_mask', torch.from_numpy(mask.copy()),
                             persistent=False)
        self.register_buffer('bm_mask', torch.from_numpy(np.array(
            [[1] * (temporal_dim - i) + [0] * i
             for i in range(temporal_dim)], np.float32)), persistent=False)

    def init_weights(self, generator: Optional[torch.Generator] = None):
        """flax's default initialisers (the JAX module's)."""
        flax_module_init(self, generator)

    @property
    def match_map(self):
        tscale = self.temporal_dim
        gap = 1.0 / tscale
        mm = []
        for idx in range(tscale):
            mm.append([[gap * idx, gap * idx + gap * j]
                       for j in range(1, tscale + 1)])
        return np.transpose(np.array(mm), [1, 0, 2]).reshape(-1, 2)

    def forward(self, raw_feature):
        """``raw_feature`` (N, tscale, feat_dim) -> (confidence_map (N,
        duration, start, 2), start (N, T), end (N, T))."""
        tscale = self.temporal_dim
        x = raw_feature.transpose(1, 2)
        x = F.relu(self.x1db_0(x))
        base = F.relu(self.x1db_1(x))
        start = torch.sigmoid(self.x1ds_1(F.relu(self.x1ds_0(base))))[:, 0]
        end = torch.sigmoid(self.x1de_1(F.relu(self.x1de_0(base))))[:, 0]
        p = F.relu(self.x1dp_0(base))
        # boundary matching: (N, C, T) x (T, S*T*T) -> (N, C, S, T, T)
        bm = torch.matmul(p, self.sample_mask.to(p.dtype)).view(
            p.shape[0], self.hidden_dim_1d, self.num_samples, tscale,
            tscale)
        bm = F.relu(self.x3dp(bm))[:, :, 0]  # (N, C3, duration, start)
        bm = F.relu(self.x2dp_0(bm))
        bm = F.relu(self.x2dp_1(bm))
        bm = F.relu(self.x2dp_2(bm))
        confidence_map = torch.sigmoid(self.x2dp_3(bm))
        return confidence_map.permute(0, 2, 3, 1), start, end

    # -- host-side label generation / inference decode -------------------
    def generate_labels(self, gt_bbox):
        """(reference bmn.py:430-470) ``gt_bbox``: a list of (M, 2)
        arrays -> numpy (N, T, T) IoU maps and (N, T) start / end
        labels."""
        tscale = self.temporal_dim
        match_map = self.match_map
        conf_list, start_list, end_list = [], [], []
        gap = 1.0 / tscale
        # boundary anchors span 2*gap centered on the cell (reference
        # bmn.py:130 _temporal_anchors(-0.5, 1.5))
        anchors_tmins = np.array([gap * (i - 0.5) for i in range(tscale)])
        anchors_tmaxs = np.array([gap * (i + 1.5) for i in range(tscale)])
        for every_gt_bbox in gt_bbox:
            every_gt_bbox = np.asarray(every_gt_bbox)
            gt_iou_map = []
            for start, end in every_gt_bbox:
                cur = temporal_iou(match_map[:, 0], match_map[:, 1],
                                   start, end)
                gt_iou_map.append(cur.reshape(tscale, tscale))
            gt_iou_map = np.max(np.array(gt_iou_map, np.float32), axis=0)
            gt_tmins = every_gt_bbox[:, 0]
            gt_tmaxs = every_gt_bbox[:, 1]
            gt_len_pad = 3 * gap
            starts = np.stack((gt_tmins - gt_len_pad / 2,
                               gt_tmins + gt_len_pad / 2), axis=1)
            ends = np.stack((gt_tmaxs - gt_len_pad / 2,
                             gt_tmaxs + gt_len_pad / 2), axis=1)
            ms_start = [np.max(temporal_iop(tmin, tmax, starts[:, 0],
                                            starts[:, 1]))
                        for tmin, tmax in zip(anchors_tmins, anchors_tmaxs)]
            ms_end = [np.max(temporal_iop(tmin, tmax, ends[:, 0],
                                          ends[:, 1]))
                      for tmin, tmax in zip(anchors_tmins, anchors_tmaxs)]
            conf_list.append(gt_iou_map)
            start_list.append(ms_start)
            end_list.append(ms_end)
        return (np.array(conf_list, np.float32),
                np.array(start_list, np.float32),
                np.array(end_list, np.float32))

    def loss(self, confidence_map, start, end, label_confidence,
             label_start, label_end, generator=None, draws=None):
        """``BMNLoss`` on the maps in the JAX orientation; ``generator`` /
        ``draws`` feed the PEM regression's sampling
        (``losses.bmn_loss``)."""
        loss = self._loss(confidence_map, start, end, label_confidence,
                          label_start, label_end,
                          self.bm_mask.to(confidence_map.dtype),
                          generator=generator, draws=draws)
        return dict(loss=loss[0], tem_loss=loss[1], pem_reg_loss=loss[2],
                    pem_cls_loss=loss[3])

    def decode_proposals(self, confidence_map, start, end, video_meta):
        """Inference decode of the first video (reference forward_test,
        bmn.py:210-270), on the host: the maps are read back once."""
        tscale = self.temporal_dim
        start_scores, end_scores, cm = (
            t[0].detach().cpu().numpy() if torch.is_tensor(t)
            else np.asarray(t[0]) for t in (start, end, confidence_map))
        reg_confidence = cm[..., 0]
        cls_confidence = cm[..., 1]
        max_start = start_scores.max()
        max_end = end_scores.max()
        start_bins = np.zeros(tscale)
        start_bins[0] = 1
        end_bins = np.zeros(tscale)
        end_bins[-1] = 1
        for idx in range(1, tscale - 1):
            if (start_scores[idx] > start_scores[idx + 1]
                    and start_scores[idx] > start_scores[idx - 1]):
                start_bins[idx] = 1
            elif start_scores[idx] > 0.5 * max_start:
                start_bins[idx] = 1
            if (end_scores[idx] > end_scores[idx + 1]
                    and end_scores[idx] > end_scores[idx - 1]):
                end_bins[idx] = 1
            elif end_scores[idx] > 0.5 * max_end:
                end_bins[idx] = 1
        new_proposals = []
        for idx in range(tscale):
            for jdx in range(tscale):
                start_index = jdx
                end_index = start_index + idx + 1
                if (end_index < tscale and start_bins[start_index] == 1
                        and end_bins[end_index] == 1):
                    tmin = start_index / tscale
                    tmax = end_index / tscale
                    score = (start_scores[start_index] *
                             end_scores[end_index] *
                             cls_confidence[idx, jdx] *
                             reg_confidence[idx, jdx])
                    new_proposals.append([
                        tmin, tmax, start_scores[start_index],
                        end_scores[end_index], cls_confidence[idx, jdx],
                        reg_confidence[idx, jdx], score])
        new_proposals = np.stack(new_proposals)
        video_info = dict(video_meta[0])
        proposal_list = post_processing(
            new_proposals, video_info, self.soft_nms_alpha,
            self.soft_nms_low_threshold, self.soft_nms_high_threshold,
            self.post_process_top_k)
        return [dict(video_name=video_info['video_name'],
                     proposal_list=proposal_list)]
