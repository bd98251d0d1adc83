"""In-repo DAVIS J&F evaluation (a copy of
``vfs_tpu/core/evaluation/davis.py``: the port needs nothing of the JAX
package).

The reference depends on the author's fork of davis2017-evaluation
(reference: mmaction/datasets/davis_dataset.py:9,68-148); SURVEY §2.9
requires re-implementing J (region IoU) and F (boundary F-measure with
morphological-dilation bipartite matching) natively. This module follows the
published DAVIS 2017 semi-supervised protocol:

  - per-sequence objects = ids in the first-frame annotation (0 = bg,
    255 = void);
  - metrics computed on frames [1:-1] (first = GT input, last excluded);
  - J = |A∩S|/|A∪S| per frame (1.0 when both empty);
  - F = 2PR/(P+R) with boundary pixels matched within a disk of radius
    ceil(0.008 * image diagonal);
  - per-object statistics: M(ean), R(ecall @ >0.5), D(ecay = first-quartile
    mean - last-quartile mean).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def seg2bmap(seg: np.ndarray) -> np.ndarray:
    """Binary boundary map of a binary mask (DAVIS benchmark seg2bmap
    semantics: a pixel is boundary if it differs from its east, south, or
    southeast neighbor; the last row/col handled separately)."""
    seg = seg.astype(bool)
    e = np.zeros_like(seg)
    s = np.zeros_like(seg)
    se = np.zeros_like(seg)
    e[:, :-1] = seg[:, 1:]
    s[:-1, :] = seg[1:, :]
    se[:-1, :-1] = seg[1:, 1:]
    b = (seg ^ e) | (seg ^ s) | (seg ^ se)
    b[-1, :] = seg[-1, :] ^ e[-1, :]
    b[:, -1] = seg[:, -1] ^ s[:, -1]
    b[-1, -1] = False
    return b


def _disk(radius: int) -> np.ndarray:
    """skimage.morphology.disk parity: (2r+1)² struct with x²+y² <= r²."""
    y, x = np.mgrid[-radius:radius + 1, -radius:radius + 1]
    return (x**2 + y**2 <= radius**2).astype(np.uint8)


def db_eval_iou(annotation: np.ndarray, segmentation: np.ndarray,
                void_pixels: np.ndarray = None) -> np.ndarray:
    """Per-frame Jaccard of binary masks (T, H, W) (or single frame)."""
    assert annotation.shape == segmentation.shape
    if void_pixels is None:
        void_pixels = np.zeros_like(annotation, dtype=bool)
    annotation = annotation.astype(bool)
    segmentation = segmentation.astype(bool)
    void_pixels = void_pixels.astype(bool)
    inters = np.sum((segmentation & annotation) & ~void_pixels,
                    axis=(-2, -1))
    union = np.sum((segmentation | annotation) & ~void_pixels, axis=(-2, -1))
    j = inters.astype(np.float64) / np.maximum(union, 1)
    if j.ndim == 0:
        return np.array(1.0) if np.isclose(union, 0) else j
    j = np.where(np.isclose(union, 0), 1.0, j)
    return j


def f_measure_frame(segmentation: np.ndarray, annotation: np.ndarray,
                    void_pixels: np.ndarray = None,
                    bound_th: float = 0.008) -> float:
    """Boundary F-measure of one frame."""
    import cv2
    if void_pixels is None:
        void_pixels = np.zeros_like(segmentation, dtype=bool)
    bound_pix = bound_th if bound_th >= 1 else int(
        np.ceil(bound_th * np.linalg.norm(segmentation.shape)))
    fg_boundary = seg2bmap(segmentation.astype(bool) & ~void_pixels)
    gt_boundary = seg2bmap(annotation.astype(bool) & ~void_pixels)
    kernel = _disk(int(bound_pix))
    fg_dil = cv2.dilate(fg_boundary.astype(np.uint8), kernel)
    gt_dil = cv2.dilate(gt_boundary.astype(np.uint8), kernel)
    gt_match = gt_boundary & (fg_dil > 0)
    fg_match = fg_boundary & (gt_dil > 0)
    n_fg = fg_boundary.sum()
    n_gt = gt_boundary.sum()
    if n_fg == 0 and n_gt > 0:
        precision, recall = 1.0, 0.0
    elif n_fg > 0 and n_gt == 0:
        precision, recall = 0.0, 1.0
    elif n_fg == 0 and n_gt == 0:
        precision, recall = 1.0, 1.0
    else:
        precision = fg_match.sum() / float(n_fg)
        recall = gt_match.sum() / float(n_gt)
    if precision + recall == 0:
        return 0.0
    return 2.0 * precision * recall / (precision + recall)


def db_eval_boundary(annotation: np.ndarray, segmentation: np.ndarray,
                     void_pixels: np.ndarray = None,
                     bound_th: float = 0.008) -> np.ndarray:
    """Per-frame boundary F of binary masks (T, H, W)."""
    t = annotation.shape[0]
    out = np.zeros(t)
    for i in range(t):
        void = None if void_pixels is None else void_pixels[i]
        out[i] = f_measure_frame(segmentation[i], annotation[i], void,
                                 bound_th)
    return out


def db_statistics(per_frame_values: np.ndarray) -> Tuple[float, float, float]:
    """(M, R, D) statistics (davis2017-evaluation utils.db_statistics
    parity, including the quartile binning)."""
    with np.errstate(invalid='ignore'):
        m = np.nanmean(per_frame_values)
        o = per_frame_values > 0.5
        r = np.nanmean(o)
        n_bins = 4
        ids = np.round(np.linspace(1, len(per_frame_values), n_bins + 1) +
                       1e-10) - 1
        ids = ids.astype(int)
        d_bins = [per_frame_values[ids[i]:ids[i + 1] + 1] for i in range(4)]
        d = np.nanmean(d_bins[0]) - np.nanmean(d_bins[3])
    return float(m), float(r), float(d)


def decompose_objects(masks: np.ndarray,
                      object_ids: List[int]) -> Tuple[np.ndarray, np.ndarray]:
    """(T, H, W) int labels -> ((O, T, H, W) bool per-object, void (T,H,W))."""
    void = masks == 255
    per_obj = np.stack([(masks == oid) for oid in object_ids], axis=0)
    return per_obj, void


def evaluate_semisupervised(
        gt_masks: np.ndarray, pred_masks: np.ndarray) -> Dict[str, Dict]:
    """Evaluate one sequence.

    Args:
        gt_masks: (T, H, W) int GT labels (0 bg, 255 void).
        pred_masks: (T, H, W) int predictions.
    Returns:
        dict with per-object J/F arrays over frames [1:-1].
    """
    first = gt_masks[0]
    object_ids = sorted(int(x) for x in np.unique(first)
                        if x != 0 and x != 255)
    gt_obj, void = decompose_objects(gt_masks, object_ids)
    pred_obj, _ = decompose_objects(pred_masks, object_ids)
    # exclude first (GT input) and last frame, DAVIS semi-supervised protocol
    gt_obj = gt_obj[:, 1:-1]
    pred_obj = pred_obj[:, 1:-1]
    void = void[1:-1]
    res = {'J': {}, 'F': {}}
    for i, oid in enumerate(object_ids):
        res['J'][oid] = db_eval_iou(gt_obj[i], pred_obj[i], void)
        res['F'][oid] = db_eval_boundary(gt_obj[i], pred_obj[i], void)
    return res


def aggregate_metrics(per_seq: Dict[str, Dict[str, Dict]]) -> Dict:
    """Aggregate per-sequence per-object J/F into the DAVIS result table
    structure the reference prints (davis_dataset.py:113-148)."""
    J = {'M': [], 'R': [], 'D': [], 'M_per_object': {}}
    F = {'M': [], 'R': [], 'D': [], 'M_per_object': {}}
    for seq, res in per_seq.items():
        for oid in res['J']:
            jm, jr, jd = db_statistics(res['J'][oid])
            fm, fr, fd = db_statistics(res['F'][oid])
            J['M'].append(jm)
            J['R'].append(jr)
            J['D'].append(jd)
            F['M'].append(fm)
            F['R'].append(fr)
            F['D'].append(fd)
            J['M_per_object'][f'{seq}_{oid}'] = jm
            F['M_per_object'][f'{seq}_{oid}'] = fm
    return {'J': J, 'F': F}
