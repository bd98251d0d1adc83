"""SSN utilities: proposal file parsing, regression decode, temporal NMS,
AP evaluation (counterpart of ``vfs_tpu/localization/ssn_utils.py``;
reference: mmaction/localization/ssn_utils.py +
core/evaluation/accuracy.py average_precision_at_temporal_iou)."""

from __future__ import annotations

from itertools import groupby

import numpy as np

from .proposal_utils import temporal_iou


def load_localize_proposal_file(filename):
    """Parse the SSN proposal file into
    [(video_id, num_frames, gt_boxes, proposal_boxes), ...]."""
    lines = list(open(filename))
    groups = groupby(lines, lambda x: x.startswith('#'))
    video_infos = [[x.strip() for x in list(g)] for k, g in groups if not k]

    def parse_group(video_info):
        offset = 0
        video_id = video_info[offset]
        offset += 1
        num_frames = int(float(video_info[1]) * float(video_info[2]))
        num_gts = int(video_info[3])
        offset = 4
        gt_boxes = [x.split() for x in video_info[offset:offset + num_gts]]
        offset += num_gts
        num_proposals = int(video_info[offset])
        offset += 1
        proposal_boxes = [
            x.split() for x in video_info[offset:offset + num_proposals]
        ]
        return video_id, num_frames, gt_boxes, proposal_boxes

    return [parse_group(video_info) for video_info in video_infos]


def perform_regression(detections):
    """Apply center/duration regression to detections
    [start, end, score, center_reg, size_reg] (reference :93-115)."""
    starts = detections[:, 0]
    ends = detections[:, 1]
    centers = (starts + ends) / 2
    durations = ends - starts
    new_centers = centers + durations * detections[:, 3]
    new_durations = durations * np.exp(detections[:, 4])
    return np.concatenate(
        (np.clip(new_centers - new_durations / 2, 0, 1)[:, None],
         np.clip(new_centers + new_durations / 2, 0, 1)[:, None],
         detections[:, 2:]), axis=1)


def temporal_nms(detections, threshold):
    """Greedy temporal NMS on [start, end, score, ...] rows
    (reference :118-143)."""
    starts = detections[:, 0]
    ends = detections[:, 1]
    scores = detections[:, 2]
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        ious = temporal_iou(starts[order[1:]], ends[order[1:]], starts[i],
                            ends[i])
        idxs = np.where(ious <= threshold)[0]
        order = order[idxs + 1]
    return detections[keep, :]


def average_precision_at_temporal_iou(ground_truth, prediction,
                                      temporal_iou_thresholds):
    """AP of one class at given tIoU thresholds (reference
    core/evaluation/accuracy.py:370-467 semantics).

    Args:
        ground_truth: {video_id: [[t_start, t_end], ...]}.
        prediction: rows [video_id, class_idx, t_start, t_end, score].
    """
    temporal_iou_thresholds = np.asarray(temporal_iou_thresholds)
    ap = np.zeros(len(temporal_iou_thresholds))
    if len(prediction) == 0:
        return ap
    num_gts = float(sum(len(v) for v in ground_truth.values()))
    if num_gts == 0:
        return ap
    num_thresholds = len(temporal_iou_thresholds)
    num_preds = len(prediction)
    prediction = sorted(prediction, key=lambda x: -float(x[4]))
    tp = np.zeros((num_thresholds, num_preds))
    fp = np.zeros((num_thresholds, num_preds))
    lock_gt = {
        vid: np.full((num_thresholds, len(gts)), -1)
        for vid, gts in ground_truth.items()
    }
    for pred_idx, pred in enumerate(prediction):
        vid = pred[0]
        if vid not in ground_truth:
            fp[:, pred_idx] = 1
            continue
        gts = np.asarray(ground_truth[vid], np.float64)
        tiou = temporal_iou(gts[:, 0], gts[:, 1], float(pred[2]),
                            float(pred[3]))
        order = tiou.argsort()[::-1]
        for t_idx, thr in enumerate(temporal_iou_thresholds):
            matched = False
            for j in order:
                if tiou[j] < thr:
                    break
                if lock_gt[vid][t_idx, j] >= 0:
                    continue
                tp[t_idx, pred_idx] = 1
                lock_gt[vid][t_idx, j] = pred_idx
                matched = True
                break
            if not matched:
                fp[t_idx, pred_idx] = 1
    tp_cum = np.cumsum(tp, axis=1).astype(np.float64)
    fp_cum = np.cumsum(fp, axis=1).astype(np.float64)
    recall = tp_cum / num_gts
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1e-12)
    for t_idx in range(num_thresholds):
        # interpolated AP (ActivityNet style)
        mprec = np.concatenate([[0], precision[t_idx], [0]])
        mrec = np.concatenate([[0], recall[t_idx], [1]])
        for i in range(len(mprec) - 1)[::-1]:
            mprec[i] = max(mprec[i], mprec[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
        ap[t_idx] = np.sum((mrec[idx] - mrec[idx - 1]) * mprec[idx])
    return ap


def eval_ap(detections, gt_by_cls, iou_range):
    """(num_classes, num_ious) AP matrix (reference :146-170)."""
    ap_values = np.zeros((len(detections), len(iou_range)))
    for iou_idx, min_overlap in enumerate(iou_range):
        for class_idx in range(len(detections)):
            ap = average_precision_at_temporal_iou(
                gt_by_cls[class_idx], detections[class_idx], [min_overlap])
            ap_values[class_idx, iou_idx] = ap[0]
    return ap_values
