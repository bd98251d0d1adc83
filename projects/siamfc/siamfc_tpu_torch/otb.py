"""OTB one-pass-evaluation (OPE) harness: precision@20px + success AUC
(counterpart of ``siamfc_tpu/otb.py``).

Replaces the got10k toolkit's ``ExperimentOTB`` (reference
train_siamfc.py:10-11,120-142 depends on got10k; SURVEY §2.9 requires an
in-repo OTB harness). Protocol: run the tracker once per sequence from the
ground-truth first box; success curve = mean over frames of IoU > t for 21
thresholds in [0, 1] (score = AUC = mean); precision curve = center-error
< t for 51 thresholds in [0, 50] px (score = value at 20 px).

``run`` holds the exact fp32 mode (``vfs_tpu_torch.exact_fp32``) around
every tracking call, its worker threads included, so that no thread's
exit can turn TF32 back on under another.
"""

from __future__ import annotations

import glob
import json
import os
import os.path as osp
from typing import Dict

import numpy as np

from vfs_tpu_torch import exact_fp32


def _load_otb_seq(seq_dir):
    """OTB layout: <seq>/img/####.jpg + groundtruth_rect.txt (some
    sequences use comma, some tab/space)."""
    img_files = sorted(glob.glob(osp.join(seq_dir, 'img', '*.jpg')))
    anno_file = osp.join(seq_dir, 'groundtruth_rect.txt')
    with open(anno_file) as f:
        text = f.read().replace(',', ' ')
    anno = np.array([[float(t) for t in line.split()]
                     for line in text.strip().split('\n')])
    # clip frame list to annotation length (OTB quirk: David etc.)
    n = min(len(img_files), len(anno))
    return img_files[:n], anno[:n]


def rect_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of ltwh boxes, got10k convention (inclusive pixel extents)."""
    lt = np.maximum(a[..., :2], b[..., :2])
    rb = np.minimum(a[..., :2] + a[..., 2:], b[..., :2] + b[..., 2:])
    inter = np.clip(rb - lt, 0, None).prod(-1)
    union = a[..., 2:].prod(-1) + b[..., 2:].prod(-1) - inter
    return inter / np.maximum(union, 1e-12)


def center_error(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ca = a[..., :2] + (a[..., 2:] - 1) / 2
    cb = b[..., :2] + (b[..., 2:] - 1) / 2
    return np.sqrt(((ca - cb)**2).sum(-1))


def eval_metrics(boxes: np.ndarray, anno: np.ndarray):
    ious = rect_iou(boxes, anno)
    errs = center_error(boxes, anno)
    succ_thresholds = np.linspace(0, 1, 21)
    prec_thresholds = np.arange(0, 51)
    succ_curve = np.mean(ious[:, None] > succ_thresholds[None], axis=0)
    prec_curve = np.mean(errs[:, None] <= prec_thresholds[None], axis=0)
    return succ_curve, prec_curve


class ExperimentOTB:
    """OPE experiment over an OTB-layout dataset directory."""

    def __init__(self, root_dir, version=2015, result_dir='results',
                 report_dir='reports'):
        self.root_dir = root_dir
        self.version = version
        self.result_dir = result_dir
        self.report_dir = report_dir
        self.seq_dirs = sorted(
            d for d in glob.glob(osp.join(root_dir, '*')) if osp.isdir(d)
            and osp.isfile(osp.join(d, 'groundtruth_rect.txt')))
        self.seq_names = [osp.basename(d) for d in self.seq_dirs]

    def run(self, tracker, visualize=False, devices=None,
            batch_size=None) -> Dict[str, np.ndarray]:
        """Track every sequence. ``devices``: round-robin sequences over
        local devices, one tracker clone (a copy of the weights on its
        device) + worker thread per device (sequences are independent).
        ``batch_size``: track K sequences per device call
        (``TrackerSiamFC.track_batch``), two interleaved streams when
        there are more sequences than K."""
        with exact_fp32():
            return self._run(tracker, visualize, devices, batch_size)

    def _run(self, tracker, visualize, devices, batch_size):
        os.makedirs(self.result_dir, exist_ok=True)
        all_boxes = {}
        if batch_size and batch_size > 1 and hasattr(tracker,
                                                     'track_batch'):
            seqs = [_load_otb_seq(d) for d in self.seq_dirs]
            pairs = [(f, a[0]) for f, a in seqs]
            # interleaved streams: while stream A blocks on its wave's
            # transfer+compute (GIL released), stream B does its
            # host-side region cuts / post-processing. With several
            # devices, one weight-replica stream per device composes
            # both levers.
            trackers = [tracker]
            if devices is not None and len(devices) > 1 \
                    and hasattr(tracker, 'clone'):
                trackers = [tracker.clone(d) for d in devices]
            n_streams = max(len(trackers),
                            2 if len(pairs) > batch_size else 1)
            if n_streams > 1:
                import concurrent.futures
                groups = [list(range(s, len(pairs), n_streams))
                          for s in range(n_streams)]
                results = [None] * len(pairs)

                def worker(s):
                    trk = trackers[s % len(trackers)]
                    sub = trk.track_batch([pairs[i] for i in groups[s]],
                                          batch_size=batch_size)
                    for i, r in zip(groups[s], sub):
                        results[i] = r
                with concurrent.futures.ThreadPoolExecutor(
                        n_streams) as pool:
                    futs = [pool.submit(worker, s)
                            for s in range(n_streams)]
                    for f in futs:
                        f.result()
            else:
                results = tracker.track_batch(pairs,
                                              batch_size=batch_size)
            for name, (boxes, times) in zip(self.seq_names, results):
                all_boxes[name] = (boxes, times)
                np.savetxt(osp.join(self.result_dir, f'{name}.txt'),
                           boxes, fmt='%.3f', delimiter=',')
            return all_boxes
        if devices is not None and len(devices) > 1 \
                and hasattr(tracker, 'clone'):
            import concurrent.futures

            def worker(t_idx):
                trk = tracker.clone(devices[t_idx])
                for i in range(t_idx, len(self.seq_dirs), len(devices)):
                    seq_dir = self.seq_dirs[i]
                    name = self.seq_names[i]
                    img_files, anno = _load_otb_seq(seq_dir)
                    boxes, times = trk.track(img_files, anno[0])
                    all_boxes[name] = (boxes, times)
                    np.savetxt(osp.join(self.result_dir, f'{name}.txt'),
                               boxes, fmt='%.3f', delimiter=',')

            with concurrent.futures.ThreadPoolExecutor(
                    len(devices)) as pool:
                futures = [pool.submit(worker, t)
                           for t in range(len(devices))]
                for f in futures:
                    f.result()
            return all_boxes
        for seq_dir, name in zip(self.seq_dirs, self.seq_names):
            img_files, anno = _load_otb_seq(seq_dir)
            boxes, times = tracker.track(img_files, anno[0],
                                         visualize=visualize)
            all_boxes[name] = (boxes, times)
            np.savetxt(osp.join(self.result_dir, f'{name}.txt'), boxes,
                       fmt='%.3f', delimiter=',')
        return all_boxes

    def report(self, all_boxes=None) -> Dict:
        succ_curves, prec_curves, speeds = [], [], []
        for seq_dir, name in zip(self.seq_dirs, self.seq_names):
            img_files, anno = _load_otb_seq(seq_dir)
            if all_boxes is not None and name in all_boxes:
                boxes, times = all_boxes[name]
            else:
                boxes = np.loadtxt(osp.join(self.result_dir, f'{name}.txt'),
                                   delimiter=',')
                times = None
            n = min(len(boxes), len(anno))
            sc, pc = eval_metrics(np.asarray(boxes)[:n], anno[:n])
            succ_curves.append(sc)
            prec_curves.append(pc)
            if times is not None and len(times) > 1:
                speeds.append(1.0 / np.mean(times[1:]))
        succ = np.mean(succ_curves, axis=0)
        prec = np.mean(prec_curves, axis=0)
        report = {
            'success_score': float(np.mean(succ)),
            'precision_score': float(prec[20]),
            'success_curve': succ.tolist(),
            'precision_curve': prec.tolist(),
            'speed_fps': float(np.mean(speeds)) if speeds else None,
        }
        os.makedirs(self.report_dir, exist_ok=True)
        with open(osp.join(self.report_dir, 'performance.json'), 'w') as f:
            json.dump(report, f, indent=2)
        return report
