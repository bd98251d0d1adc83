"""Temporal-proposal metrics (counterpart of
``vfs_tpu/core/evaluation/proposal.py``; reference:
mmaction/core/evaluation/accuracy.py:170-330). Host-side numpy.
``get_weighted_score`` lives in ``accuracy`` and is re-exported here."""

from __future__ import annotations

import numpy as np

from .accuracy import get_weighted_score  # noqa: F401  (re-export)


def pairwise_temporal_iou(candidate_segments, target_segments):
    """(n, m) IoU matrix between target (n, 2) and candidate (m, 2)
    segments."""
    if target_segments.ndim != 2 or candidate_segments.ndim not in (1, 2):
        raise ValueError('Dimension of arguments is incorrect')
    if candidate_segments.ndim == 1:
        candidate_segments = candidate_segments[np.newaxis, :]
    n, m = target_segments.shape[0], candidate_segments.shape[0]
    t_iou = np.empty((n, m), dtype=np.float32)
    for i in range(m):
        cand = candidate_segments[i, :]
        tt1 = np.maximum(cand[0], target_segments[:, 0])
        tt2 = np.minimum(cand[1], target_segments[:, 1])
        inter = (tt2 - tt1).clip(0)
        union = ((target_segments[:, 1] - target_segments[:, 0]) +
                 (cand[1] - cand[0]) - inter)
        t_iou[:, i] = inter.astype(float) / union
    return t_iou


def average_recall_at_avg_proposals(ground_truth, proposals,
                                    total_num_proposals,
                                    max_avg_proposals=None,
                                    temporal_iou_thresholds=np.linspace(
                                        0.5, 0.95, 10)):
    """AR@AN curve + AUC (reference accuracy.py:208-330)."""
    total_num_videos = len(ground_truth)
    if not max_avg_proposals:
        max_avg_proposals = float(total_num_proposals) / total_num_videos
    ratio = (max_avg_proposals * float(total_num_videos) /
             total_num_proposals)
    score_list = []
    total_num_retrieved_proposals = 0
    for video_id in ground_truth:
        proposals_video_id = proposals[video_id]
        this_video_proposals = proposals_video_id[:, :2]
        sort_idx = proposals_video_id[:, 2].argsort()[::-1]
        this_video_proposals = this_video_proposals[sort_idx, :].astype(
            np.float32)
        this_video_gt = ground_truth[video_id][:, :2].astype(np.float32)
        if this_video_proposals.shape[0] == 0:
            score_list.append(np.zeros((this_video_gt.shape[0], 1)))
            continue
        if this_video_proposals.ndim != 2:
            this_video_proposals = this_video_proposals[np.newaxis]
        if this_video_gt.ndim != 2:
            this_video_gt = this_video_gt[np.newaxis]
        num_retrieved = min(int(this_video_proposals.shape[0] * ratio),
                            this_video_proposals.shape[0])
        total_num_retrieved_proposals += num_retrieved
        score_list.append(pairwise_temporal_iou(
            this_video_proposals[:num_retrieved, :], this_video_gt))
    pcn_list = np.arange(1, 101) / 100.0 * (
        max_avg_proposals * float(total_num_videos) /
        total_num_retrieved_proposals)
    matches = np.empty((total_num_videos, pcn_list.shape[0]))
    positives = np.empty(total_num_videos)
    recall = np.empty((temporal_iou_thresholds.shape[0],
                       pcn_list.shape[0]))
    for ridx, t_iou_thr in enumerate(temporal_iou_thresholds):
        for i, score in enumerate(score_list):
            positives[i] = score.shape[0]
            true_pos = score >= t_iou_thr
            pcn_proposals = np.minimum(
                (score.shape[1] * pcn_list).astype(np.int64),
                score.shape[1])
            for j, num in enumerate(pcn_proposals):
                matches[i, j] = np.count_nonzero(
                    true_pos[:, :num].sum(axis=1))
        recall[ridx, :] = matches.sum(axis=0) / positives.sum()
    avg_recall = recall.mean(axis=0)
    proposals_per_video = pcn_list * (
        float(total_num_retrieved_proposals) / total_num_videos)
    area_under_curve = np.trapezoid(avg_recall, proposals_per_video)
    auc = 100.0 * float(area_under_curve) / proposals_per_video[-1]
    return recall, avg_recall, proposals_per_video, auc

