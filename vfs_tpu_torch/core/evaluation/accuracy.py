"""Recognition metrics and the VIP eval's segmentation mIoU (counterpart
of ``vfs_tpu/core/evaluation/accuracy.py`` and of ``get_weighted_score``
in ``vfs_tpu/core/evaluation/proposal.py``; reference:
mmaction/core/evaluation/{accuracy,iou}.py)."""

from __future__ import annotations

import numpy as np


def confusion_matrix(y_pred, y_real, normalize=None):
    if normalize not in ('true', 'pred', 'all', None):
        raise ValueError("normalize must be one of 'true', 'pred', 'all', "
                         'None')
    y_pred = np.asarray(y_pred)
    y_real = np.asarray(y_real)
    if y_pred.dtype not in (np.int32, np.int64):
        raise TypeError(f'y_pred dtype must be int, got {y_pred.dtype}')
    if y_real.dtype not in (np.int32, np.int64):
        raise TypeError(f'y_real dtype must be int, got {y_real.dtype}')
    label_set = np.unique(np.concatenate((y_pred, y_real)))
    num_labels = len(label_set)
    label_map = {label: i for i, label in enumerate(label_set)}
    confusion_mat = np.zeros((num_labels, num_labels), dtype=np.int64)
    for rlabel, plabel in zip(y_real, y_pred):
        confusion_mat[label_map[rlabel], label_map[plabel]] += 1
    with np.errstate(all='ignore'):
        if normalize == 'true':
            confusion_mat = confusion_mat / confusion_mat.sum(
                axis=1, keepdims=True)
        elif normalize == 'pred':
            confusion_mat = confusion_mat / confusion_mat.sum(
                axis=0, keepdims=True)
        elif normalize == 'all':
            confusion_mat = confusion_mat / confusion_mat.sum()
        confusion_mat = np.nan_to_num(confusion_mat)
    return confusion_mat


def mean_class_accuracy(scores, labels):
    pred = np.argmax(scores, axis=1)
    cf_mat = confusion_matrix(pred.astype(np.int64),
                              np.asarray(labels).astype(np.int64))
    cls_cnt = cf_mat.sum(axis=1)
    cls_hit = np.diag(cf_mat)
    return np.mean(
        [hit / cnt if cnt else 0.0 for cnt, hit in zip(cls_cnt, cls_hit)])


def top_k_accuracy(scores, labels, topk=(1,)):
    res = []
    labels = np.asarray(labels)
    for k in topk:
        max_k_preds = np.argsort(np.asarray(scores), axis=1)[:, -k:][:, ::-1]
        match = np.logical_or.reduce(
            max_k_preds == labels[:, None], axis=1)
        res.append(match.sum() / match.shape[0])
    return res


def mean_average_precision(scores, labels):
    results = []
    scores = np.stack(scores)
    labels = np.stack(labels)
    for c in range(labels.shape[1]):
        precision, recall, _ = binary_precision_recall_curve(
            scores[:, c], labels[:, c])
        ap = -np.sum(np.diff(recall) * np.array(precision)[:-1])
        results.append(ap)
    results = [x for x in results if not np.isnan(x)]
    if not results:
        return np.nan
    return np.mean(results)


def binary_precision_recall_curve(y_score, y_true):
    y_score = np.asarray(y_score)
    y_true = np.asarray(y_true)
    desc_order = np.argsort(y_score, kind='mergesort')[::-1]
    y_score = y_score[desc_order]
    y_true = y_true[desc_order]
    distinct_inds = np.where(np.diff(y_score))[0]
    threshold_inds = np.r_[distinct_inds, y_true.size - 1]
    tps = np.cumsum(y_true)[threshold_inds]
    fps = 1 + threshold_inds - tps
    thresholds = y_score[threshold_inds]
    with np.errstate(all='ignore'):
        precision = tps / (tps + fps)
    precision[np.isnan(precision)] = 0
    recall = tps / tps[-1] if tps[-1] > 0 else np.zeros_like(tps)
    last_ind = tps.searchsorted(tps[-1])
    sl = slice(last_ind, None, -1)
    return (np.r_[precision[sl], 1], np.r_[recall[sl], 0],
            thresholds[sl])


def get_weighted_score(score_list, coeff_list):
    """The weighted sum of several models' score lists (reference
    accuracy.py:332-360)."""
    assert len(score_list) == len(coeff_list)
    scores = np.array(score_list)
    coeff = np.array(coeff_list)
    return list(np.dot(scores.T, coeff).T)


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
