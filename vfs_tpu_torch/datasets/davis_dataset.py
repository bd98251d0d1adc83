"""DAVIS-2017 semi-supervised VOS dataset + in-repo J&F evaluation
(counterpart of ``vfs_tpu/datasets/davis_dataset.py``).

Reference: mmaction/datasets/davis_dataset.py:18-181. Differences: the J&F
metric is computed in-repo (``vfs_tpu_torch.core.evaluation.davis``)
instead of the external davis2017-evaluation fork; GT masks are read from
``anno_prefix`` per video.
"""

from __future__ import annotations

import copy
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np

from ..core.evaluation.davis import (aggregate_metrics,
                                     evaluate_semisupervised)
from ..utils import add_prefix, get_root_logger
from .rawframe_dataset import RawframeDataset
from .registry import DATASETS

PALETTE = [[0, 0, 0], [128, 0, 0], [0, 128, 0], [128, 128, 0], [0, 0, 128],
           [128, 0, 128], [0, 128, 128], [128, 128, 128], [64, 0, 0],
           [191, 0, 0], [64, 128, 0], [191, 128, 0], [64, 0, 128],
           [191, 0, 128], [64, 128, 128], [191, 128, 128], [0, 64, 0],
           [128, 64, 0], [0, 191, 0], [128, 191, 0], [0, 64, 128],
           [128, 64, 128]]


@DATASETS.register_module()
class DavisDataset(RawframeDataset):

    PALETTE = PALETTE

    def __init__(self, ann_file, pipeline, data_prefix=None,
                 anno_prefix=None, test_mode=False, split='val',
                 data_root='data/davis2017', task='semi-supervised'):
        assert split in ('train', 'val')
        assert task in ('semi-supervised',)
        self.split = split
        self.data_root = data_root
        self.task = task
        self.anno_prefix = anno_prefix
        super().__init__(
            ann_file, pipeline, data_prefix, test_mode,
            filename_tmpl='{:05}.jpg', with_offset=False, multi_class=False,
            num_classes=None, start_index=0, modality='RGB')

    def prepare_test_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        ann_frame_dir = results['frame_dir'].replace(self.data_prefix,
                                                     self.anno_prefix)
        results['seg_map'] = osp.join(
            ann_frame_dir,
            self.filename_tmpl.format(0).replace('jpg', 'png'))
        return self.pipeline(results)

    # -- ground truth -------------------------------------------------------
    def _load_gt_masks(self, vid_idx: int) -> np.ndarray:
        """All GT annotation PNGs of a video as an (T, H, W) int array."""
        from PIL import Image
        info = self.video_infos[vid_idx]
        ann_dir = info['frame_dir'].replace(self.data_prefix,
                                            self.anno_prefix)
        masks = []
        for i in range(info['total_frames']):
            path = osp.join(
                ann_dir, self.filename_tmpl.format(i).replace('jpg', 'png'))
            masks.append(np.asarray(Image.open(path)))
        return np.stack(masks)

    # -- evaluation ----------------------------------------------------------
    def davis_evaluate(self, results, output_dir: Optional[str] = None,
                       logger=None) -> Dict[str, float]:
        assert len(results) == len(self)
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
        per_seq = {}
        for vid_idx in range(len(self)):
            cur = results[vid_idx]
            if isinstance(cur, str):  # save_np spill path
                path = cur
                cur = np.load(path)
                os.remove(path)
            cur = np.asarray(cur)
            gt = self._load_gt_masks(vid_idx)
            assert cur.shape[0] == gt.shape[0], \
                f'{cur.shape} vs {gt.shape}'
            seq = osp.basename(self.video_infos[vid_idx]['frame_dir'])
            per_seq[seq] = evaluate_semisupervised(gt, cur.astype(np.int64))
            if output_dir is not None:
                self._save_palette_pngs(cur, vid_idx, output_dir)
        metrics = aggregate_metrics(per_seq)
        J, F = metrics['J'], metrics['F']
        final_mean = (np.mean(J['M']) + np.mean(F['M'])) / 2.0
        eval_results = {
            'J&F-Mean': final_mean,
            'J-Mean': float(np.mean(J['M'])),
            'J-Recall': float(np.mean(J['R'])),
            'J-Decay': float(np.mean(J['D'])),
            'F-Mean': float(np.mean(F['M'])),
            'F-Recall': float(np.mean(F['R'])),
            'F-Decay': float(np.mean(F['D'])),
        }
        log = get_root_logger() if logger is None else logger
        log.info(f'Global results for {self.split}: ' + ' '.join(
            f'{k}={v:.4f}' for k, v in eval_results.items()))
        return eval_results

    def _save_palette_pngs(self, preds: np.ndarray, vid_idx: int,
                           output_dir: str):
        from PIL import Image
        info = self.video_infos[vid_idx]
        for img_idx in range(info['total_frames']):
            img = Image.fromarray(preds[img_idx].astype(np.uint8))
            img.putpalette(
                np.asarray(self.PALETTE, dtype=np.uint8).ravel())
            save_path = osp.join(
                output_dir, osp.relpath(info['frame_dir'], self.data_prefix),
                self.filename_tmpl.format(img_idx).replace('jpg', 'png'))
            os.makedirs(osp.dirname(save_path), exist_ok=True)
            img.save(save_path)

    def evaluate(self, results, metrics='davis', output_dir=None,
                 logger=None) -> Dict[str, float]:
        """Multi-feat results get ``feat_{i}.`` prefixes (reference
        davis_dataset.py:150-181)."""
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        for metric in metrics:
            if metric != 'davis':
                raise KeyError(f'metric {metric} is not supported')
        eval_results: Dict[str, float] = {}
        first = results[0]
        is_multi_feat = (isinstance(first, np.ndarray) and first.ndim == 4) \
            or isinstance(first, list)
        if is_multi_feat:
            num_feats = len(first)
            for feat_idx in range(num_feats):
                cur_results = [r[feat_idx] for r in results]
                eval_results.update(add_prefix(
                    self.davis_evaluate(cur_results, output_dir, logger),
                    prefix=f'feat_{feat_idx}'))
        else:
            eval_results.update(
                self.davis_evaluate(results, output_dir, logger))
        copypaste = [f'{float(v) * 100:.2f}'
                     for k, v in eval_results.items() if 'J&F' in k]
        get_root_logger().info(
            f'Results copypaste  {",".join(copypaste)}')
        return eval_results
