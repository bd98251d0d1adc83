"""Temporal proposal utilities (counterpart of
``vfs_tpu/localization/proposal_utils.py``; reference:
mmaction/localization/proposal_utils.py + models/localizers/utils/
post_processing.py). Host-side numpy."""

from __future__ import annotations

import numpy as np


def temporal_iou(proposal_min, proposal_max, gt_min, gt_max):
    """IoU between temporal proposals and a groundtruth segment."""
    len_anchors = proposal_max - proposal_min
    int_tmin = np.maximum(proposal_min, gt_min)
    int_tmax = np.minimum(proposal_max, gt_max)
    inter_len = np.maximum(int_tmax - int_tmin, 0.0)
    union_len = len_anchors - inter_len + gt_max - gt_min
    return np.divide(inter_len, union_len)


def temporal_iop(proposal_min, proposal_max, gt_min, gt_max):
    """Intersection over proposal duration."""
    len_anchors = np.array(proposal_max - proposal_min)
    int_tmin = np.maximum(proposal_min, gt_min)
    int_tmax = np.minimum(proposal_max, gt_max)
    inter_len = np.maximum(int_tmax - int_tmin, 0.0)
    return np.divide(inter_len, len_anchors)


def soft_nms(proposals, alpha, low_threshold, high_threshold, top_k):
    """Gaussian soft NMS for temporal proposals (last column = score)."""
    proposals = proposals[proposals[:, -1].argsort()[::-1]]
    tstart = list(proposals[:, 0])
    tend = list(proposals[:, 1])
    tscore = list(proposals[:, -1])
    rstart, rend, rscore = [], [], []
    while len(tscore) > 0 and len(rscore) <= top_k:
        max_index = int(np.argmax(tscore))
        max_width = tend[max_index] - tstart[max_index]
        iou_list = temporal_iou(tstart[max_index], tend[max_index],
                                np.array(tstart), np.array(tend))
        iou_exp_list = np.exp(-np.square(iou_list) / alpha)
        for idx in range(len(tscore)):
            if idx != max_index:
                if iou_list[idx] > low_threshold + (
                        high_threshold - low_threshold) * max_width:
                    tscore[idx] = tscore[idx] * iou_exp_list[idx]
        rstart.append(tstart.pop(max_index))
        rend.append(tend.pop(max_index))
        rscore.append(tscore.pop(max_index))
    return np.stack([np.array(rstart), np.array(rend),
                     np.array(rscore)], axis=1)


def post_processing(result, video_info, soft_nms_alpha,
                    soft_nms_low_threshold, soft_nms_high_threshold,
                    post_process_top_k):
    """Soft-NMS + duration rescale into the result-dict proposals list."""
    if len(result) > 1:
        result = soft_nms(result, soft_nms_alpha, soft_nms_low_threshold,
                          soft_nms_high_threshold, post_process_top_k)
    result = result[result[:, -1].argsort()[::-1]]
    video_duration = float(
        video_info['duration_frame'] // 16 * 16) / video_info[
            'duration_frame'] * video_info['duration_second']
    proposal_list = []
    for j in range(min(post_process_top_k, len(result))):
        proposal_list.append({
            'score': float(result[j, -1]),
            'segment': [max(0, result[j, 0]) * video_duration,
                        min(1, result[j, 1]) * video_duration],
        })
    return proposal_list
