"""SSN head with structured temporal pyramid pooling (counterpart of
``vfs_tpu/models/heads/ssn_head.py``; reference:
mmaction/models/heads/ssn_head.py).

``STPPTrain`` pools each proposal's (starting, course, ending) segments
on the device with static splits. ``STPPTest`` pools per-frame scores over
each proposal's own ticks, a variable number a proposal, on the host in
numpy, as the JAX package and the reference do. ``SSNHead.test_fc`` is
the reference's ``prepare_test_fc``: the three classifiers rearranged
into one that scores a frame for every STPP part, whose output
``STPPTest`` pools.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..registry import HEADS
from .recognition_heads import dropout


def parse_stage_config(stage_cfg):
    """(reference ssn_head.py:8-25)."""
    if isinstance(stage_cfg, int):
        return (stage_cfg,), stage_cfg
    if isinstance(stage_cfg, (tuple, list)):
        return tuple(stage_cfg), sum(stage_cfg)
    raise ValueError(f'Incorrect STPP config {stage_cfg}')


class STPPTrain:
    """Training-time STPP (reference ssn_head.py:28-123), functional."""

    def __init__(self, stpp_stage=(1, (1, 2), 1),
                 num_segments_list=(2, 5, 2), standalong_classifier=True):
        s_part, s_mult = parse_stage_config(stpp_stage[0])
        c_part, c_mult = parse_stage_config(stpp_stage[1])
        e_part, e_mult = parse_stage_config(stpp_stage[2])
        self.num_multipliers = s_mult + c_mult + e_mult
        self.stpp_stages = (s_part, c_part, e_part)
        self.multiplier_list = (s_mult, c_mult, e_mult)
        self.num_segments_list = num_segments_list

    def _extract_stage_feature(self, stage_feat, stage_parts,
                               num_multipliers, scale_factors, num_samples):
        feats = []
        stage_len = stage_feat.shape[1]
        for stage_part in stage_parts:
            ticks = np.arange(0, stage_len + 1e-5,
                              stage_len / stage_part).astype(int)
            for i in range(stage_part):
                part = stage_feat[:, ticks[i]:ticks[i + 1], :].mean(
                    dim=1) / num_multipliers
                if scale_factors is not None:
                    part = part * scale_factors.reshape(num_samples, 1)
                feats.append(part)
        return feats

    def __call__(self, x, scale_factors) -> Tuple:
        """``x`` (N * segments, C) -> the course feature (N, C) and the
        STPP feature (N, C * num_multipliers)."""
        x0 = self.num_segments_list[0]
        x1 = x0 + self.num_segments_list[1]
        num_segments = x1 + self.num_segments_list[2]
        feat_dim = x.shape[-1]
        x = x.reshape(-1, num_segments, feat_dim)
        num_samples = x.shape[0]
        scale_factors = scale_factors.reshape(-1, 2)
        feats = []
        feats.extend(self._extract_stage_feature(
            x[:, :x0], self.stpp_stages[0], self.multiplier_list[0],
            scale_factors[:, 0], num_samples))
        feats.extend(self._extract_stage_feature(
            x[:, x0:x1], self.stpp_stages[1], self.multiplier_list[1],
            None, num_samples))
        feats.extend(self._extract_stage_feature(
            x[:, x1:], self.stpp_stages[2], self.multiplier_list[2],
            scale_factors[:, 1], num_samples))
        stpp_feat = torch.cat(feats, dim=1)
        course_feat = x[:, x0:x1].mean(dim=1)
        return course_feat, stpp_feat


class STPPTest:
    """Test-time STPP over variable proposal ticks (host numpy; reference
    ssn_head.py:126-268)."""

    def __init__(self, num_classes, use_regression=True,
                 stpp_stage=(1, (1, 2), 1)):
        self.activity_score_len = num_classes + 1
        self.complete_score_len = num_classes
        self.reg_score_len = num_classes * 2
        self.use_regression = use_regression
        s_parts, s_mult = parse_stage_config(stpp_stage[0])
        c_parts, c_mult = parse_stage_config(stpp_stage[1])
        e_parts, e_mult = parse_stage_config(stpp_stage[2])
        self.num_multipliers = s_mult + c_mult + e_mult
        self.feat_dim = self.activity_score_len + self.num_multipliers * (
            self.complete_score_len +
            (self.reg_score_len if use_regression else 0))
        self.stpp_stage = (s_parts, c_parts, e_parts)
        self.act_sl = slice(0, self.activity_score_len)
        self.com_sl = slice(self.act_sl.stop, self.act_sl.stop +
                            self.complete_score_len * self.num_multipliers)
        self.reg_sl = slice(self.com_sl.stop, self.com_sl.stop +
                            self.reg_score_len * self.num_multipliers)

    def _pyramids_pooling(self, out_scores, index, raw_scores, ticks,
                          scale_factors, score_len, stpp_stage):
        offset = 0
        for stage_idx, stage_cfg in enumerate(stpp_stage):
            if stage_idx == 0:
                scale_factor = scale_factors[0]
            elif stage_idx == len(stpp_stage) - 1:
                scale_factor = scale_factors[1]
            else:
                scale_factor = 1.0
            sum_parts = sum(stage_cfg)
            tick_left = float(ticks[stage_idx])
            tick_right = float(max(ticks[stage_idx] + 1,
                                   ticks[stage_idx + 1]))
            if tick_right <= 0 or tick_left >= raw_scores.shape[0]:
                offset += sum_parts
                continue
            for num_parts in stage_cfg:
                part_ticks = np.arange(
                    tick_left, tick_right + 1e-5,
                    (tick_right - tick_left) / num_parts).astype(int)
                for i in range(num_parts):
                    pl_, pr = part_ticks[i], part_ticks[i + 1]
                    if pr - pl_ >= 1:
                        raw = raw_scores[pl_:pr,
                                         offset * score_len:
                                         (offset + 1) * score_len]
                        out_scores[index, :] += raw.mean(0) * scale_factor
                    offset += 1
        return out_scores

    def __call__(self, x, proposal_ticks, scale_factors):
        x = np.asarray(x)
        assert x.shape[1] == self.feat_dim
        num_ticks = len(proposal_ticks)
        out_act = np.zeros((num_ticks, self.activity_score_len), x.dtype)
        raw_act = x[:, self.act_sl]
        out_com = np.zeros((num_ticks, self.complete_score_len), x.dtype)
        raw_com = x[:, self.com_sl]
        if self.use_regression:
            out_reg = np.zeros((num_ticks, self.reg_score_len), x.dtype)
            raw_reg = x[:, self.reg_sl]
        else:
            out_reg = None
        for i in range(num_ticks):
            ticks = proposal_ticks[i]
            out_act[i, :] = raw_act[
                int(ticks[1]):max(int(ticks[1]) + 1,
                                  int(ticks[2])), :].mean(0)
            out_com = self._pyramids_pooling(
                out_com, i, raw_com, ticks, scale_factors[i],
                self.complete_score_len, self.stpp_stage)
            if self.use_regression:
                out_reg = self._pyramids_pooling(
                    out_reg, i, raw_reg, ticks, scale_factors[i],
                    self.reg_score_len, self.stpp_stage)
        return out_act, out_com, out_reg


@HEADS.register_module()
class SSNHead(nn.Module):
    """SSN classification head (reference ssn_head.py:273-420): the
    activity classifier on the course feature, the completeness
    classifier and the regressor on the STPP feature, each behind
    dropout in training."""

    def __init__(self, dropout_ratio=0.8, in_channels=1024, num_classes=20,
                 consensus=None, use_regression=True, init_std=0.001):
        super().__init__()
        self.dropout_ratio = dropout_ratio
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.use_regression = use_regression
        self.init_std = init_std
        cfg = dict(consensus or dict(
            type='STPPTrain', stpp_cfg=(1, 1, 1), num_seg=(2, 5, 2)))
        cfg.pop('type', None)
        # the reference STPPTrain spellings too (ssn_head.py:38)
        stpp_cfg = cfg.pop('stpp_cfg', cfg.pop('stpp_stage',
                                               (1, (1, 2), 1)))
        num_seg = cfg.pop('num_seg', cfg.pop('num_segments_list',
                                             (2, 5, 2)))
        self.stpp_cfg = stpp_cfg
        self.consensus = STPPTrain(stpp_stage=stpp_cfg,
                                   num_segments_list=num_seg)
        mult = self.consensus.num_multipliers
        self.activity_fc = nn.Linear(in_channels, num_classes + 1)
        self.completeness_fc = nn.Linear(in_channels * mult, num_classes)
        if use_regression:
            self.regressor_fc = nn.Linear(in_channels * mult,
                                          num_classes * 2)

    def flax_init(self, generator=None):
        for fc in self.fcs():
            fc.weight.normal_(0.0, self.init_std, generator=generator)
            fc.bias.zero_()

    def fcs(self):
        return [self.activity_fc, self.completeness_fc] + (
            [self.regressor_fc] if self.use_regression else [])

    def forward(self, x, proposal_scale_factor,
                generator: Optional[torch.Generator] = None):
        """``x`` (N * segments, C) pooled features -> activity (N,
        classes + 1), completeness (N, classes) and, with regression, box
        offsets (N, classes, 2)."""
        activity_feat, completeness_feat = self.consensus(
            x, proposal_scale_factor)
        if self.dropout_ratio and self.training:
            activity_feat = dropout(activity_feat, self.dropout_ratio,
                                    generator)
            completeness_feat = dropout(completeness_feat,
                                        self.dropout_ratio, generator)
        activity_scores = self.activity_fc(activity_feat)
        complete_scores = self.completeness_fc(completeness_feat)
        bbox_preds = None
        if self.use_regression:
            bbox_preds = self.regressor_fc(completeness_feat).reshape(
                -1, self.num_classes, 2)
        return activity_scores, complete_scores, bbox_preds

    def test_fc(self, x):
        """Per-frame scores for ``STPPTest``: ``x`` (frames, C) -> (frames,
        classes + 1 + parts * (classes [+ 2 * classes])), the activity
        scores, then each STPP part's completeness scores, then each
        part's regression (reference ``prepare_test_fc``: a
        classifier's weight split by part, its bias shared out evenly)."""
        mult = self.consensus.num_multipliers
        weights, biases = [self.activity_fc.weight], [self.activity_fc.bias]
        for fc in self.fcs()[1:]:
            out = fc.out_features
            weights.append(fc.weight.reshape(out, mult, self.in_channels)
                           .transpose(0, 1).reshape(-1, self.in_channels))
            biases.append(fc.bias.expand(mult, out).reshape(-1) / mult)
        return nn.functional.linear(x, torch.cat(weights), torch.cat(biases))
