"""Segmentation mIoU for the VIP eval (counterpart of ``mean_iou`` in
``vfs_tpu/core/evaluation/accuracy.py``; reference:
mmaction/core/evaluation/iou.py)."""

from __future__ import annotations

import numpy as np


def mean_iou(results, gt_seg_maps, num_classes, ignore_index=255):
    """Accumulate per-class intersection and union over every (prediction,
    label) map pair; pixels labelled ``ignore_index`` are left out.
    Returns (overall accuracy, per-class accuracy, per-class IoU); a class
    absent from both gives NaN."""
    total_intersect = np.zeros((num_classes,), np.float64)
    total_union = np.zeros((num_classes,), np.float64)
    total_pred = np.zeros((num_classes,), np.float64)
    total_label = np.zeros((num_classes,), np.float64)
    for pred, label in zip(results, gt_seg_maps):
        pred = np.asarray(pred)
        label = np.asarray(label)
        mask = label != ignore_index
        pred = pred[mask]
        label = label[mask]
        intersect = pred[pred == label]
        area_i = np.histogram(intersect, bins=num_classes,
                              range=(0, num_classes - 1))[0]
        area_p = np.histogram(pred, bins=num_classes,
                              range=(0, num_classes - 1))[0]
        area_l = np.histogram(label, bins=num_classes,
                              range=(0, num_classes - 1))[0]
        total_intersect += area_i
        total_pred += area_p
        total_label += area_l
        total_union += area_p + area_l - area_i
    all_acc = total_intersect.sum() / max(total_label.sum(), 1)
    with np.errstate(all='ignore'):
        acc = total_intersect / total_label
        iou = total_intersect / total_union
    return all_acc, acc, iou
