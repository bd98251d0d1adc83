"""JHMDB pose-keypoint propagation dataset + PCK evaluation (counterpart of
``vfs_tpu/datasets/jhmdb_dataset.py``).

Reference: mmaction/datasets/jhmdb_dataset.py:15-242. The joints come
from ``joint_positions.mat`` (read with ``scipy.io``); the first frame's
joints become gaussian label maps (the ``pose_coord``/``sigma`` branch of
``RawFrameDecode``), propagation returns soft heatmaps, and ``img2coord``
decodes them by a top-k soft-argmax.
"""

from __future__ import annotations

import copy
import os
import os.path as osp

import numpy as np

from ..utils import add_prefix, get_root_logger
from .rawframe_dataset import RawframeDataset
from .registry import DATASETS


@DATASETS.register_module()
class JHMDBDataset(RawframeDataset):

    NUM_KEYPOINTS = 15

    def __init__(self, ann_file, pipeline, data_prefix=None,
                 anno_prefix=None, test_mode=False, split='val',
                 data_root='data/jhmdb', task='semi-supervised', sigma=4):
        assert split in ('train', 'val')
        assert task in ('semi-supervised',)
        self.split = split
        self.data_root = data_root
        self.task = task
        self.anno_prefix = anno_prefix
        self.sigma = sigma
        super().__init__(
            ann_file, pipeline, data_prefix, test_mode,
            filename_tmpl='{:05}.png', with_offset=False, multi_class=False,
            num_classes=None, start_index=1, modality='RGB')

    def _pose_path(self, frame_dir):
        return osp.join(
            frame_dir.replace(self.data_prefix, self.anno_prefix).replace(
                'Frames', 'joint_positions'), 'joint_positions.mat')

    def prepare_test_frames(self, idx):
        import scipy.io as sio
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        pose_mat = sio.loadmat(self._pose_path(results['frame_dir']))
        # 'pos_img' is (2, 15, clip_len), 1-indexed (reference :103)
        results['pose_coord'] = pose_mat['pos_img'][..., 0] - 1
        results['sigma'] = self.sigma
        return self.pipeline(results)

    @staticmethod
    def compute_pck(dist_all, dist_thresh):
        """Percentage of each joint's distances within ``dist_thresh``."""
        pck_all = np.zeros((len(dist_all),))
        for pidx in range(len(dist_all)):
            idxs = np.argwhere(dist_all[pidx] <= dist_thresh)
            pck_all[pidx] = 100.0 * len(idxs) / max(len(dist_all[pidx]), 1)
        return pck_all

    def img2coord(self, imgs, topk=5):
        """Top-k soft-argmax heatmap decode (reference :118-136): imgs
        (clip_len, NUM_KEYPOINTS, H, W) -> (2, NUM_KEYPOINTS, clip_len) x, y
        coordinates, -1 where a heatmap is all zero."""
        clip_len = len(imgs)
        height, width = imgs.shape[2:]
        assert imgs.shape[:2] == (clip_len, self.NUM_KEYPOINTS)
        coords = np.zeros((2, self.NUM_KEYPOINTS, clip_len), np.float64)
        imgs = imgs.reshape(clip_len, self.NUM_KEYPOINTS, -1)
        topk_indices = np.argsort(imgs, axis=-1)[..., -topk:]
        topk_values = np.take_along_axis(imgs, topk_indices, axis=-1)
        topk_values = topk_values / np.sum(topk_values, keepdims=True,
                                           axis=-1)
        topk_x = topk_indices % width
        topk_y = topk_indices // width
        coords[0] = np.sum(topk_x * topk_values, axis=-1).T
        coords[1] = np.sum(topk_y * topk_values, axis=-1).T
        coords[:, np.sum(imgs.transpose(1, 0, 2), axis=-1) == 0] = -1
        return coords

    def pck_evaluate(self, results, output_dir=None, logger=None):
        """PCK@0.1..0.5 of the decoded joints against the ground truth, the
        distance normalised per frame by 0.6 x the diagonal of the visible
        joints' box (reference :138-207)."""
        import scipy.io as sio
        dist_all = [np.zeros((0,)) for _ in range(self.NUM_KEYPOINTS)]
        for vid_idx in range(len(results)):
            cur_results = results[vid_idx]
            if isinstance(cur_results, str):  # save_np spill path
                path = cur_results
                cur_results = np.load(path)
                os.remove(path)
            gt_poses = sio.loadmat(self._pose_path(
                self.video_infos[vid_idx]['frame_dir']))['pos_img'] - 1
            clip_len = min(self.video_infos[vid_idx]['total_frames'],
                           gt_poses.shape[-1])
            cur_results = np.asarray(cur_results)[:clip_len]
            pred_poses = self.img2coord(cur_results)
            pred_poses = pred_poses[..., :clip_len]
            gt_poses = gt_poses[..., :clip_len]
            joint_visible = pred_poses[0] > 0
            valid_max = gt_poses.copy()
            valid_max[:, ~joint_visible] = -1
            valid_min = gt_poses.copy()
            valid_min[:, ~joint_visible] = 1e6
            boxes = np.stack(
                (valid_max[0].max(axis=0) - valid_min[0].min(axis=0),
                 valid_max[1].max(axis=0) - valid_min[1].min(axis=0)),
                axis=0)
            boxes = 0.6 * np.linalg.norm(boxes, axis=0)
            for img_idx in range(clip_len):
                if boxes[img_idx] <= 0:
                    continue
                for t in range(self.NUM_KEYPOINTS):
                    if not joint_visible[t, img_idx]:
                        continue
                    dist = np.linalg.norm(
                        pred_poses[:2, t, img_idx] -
                        gt_poses[:2, t, img_idx]) / boxes[img_idx]
                    dist_all[t] = np.append(dist_all[t], [dist])
        eval_results = {}
        for pck_range in (0.1, 0.2, 0.3, 0.4, 0.5):
            eval_results[f'PCK@{pck_range}'] = float(
                np.mean(self.compute_pck(dist_all, pck_range)))
        return eval_results

    def evaluate(self, results, metrics='pck', output_dir=None, logger=None):
        """Multi-feat results get ``feat_{i}.`` prefixes."""
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        for metric in metrics:
            if metric != 'pck':
                raise KeyError(f'metric {metric} is not supported')
        eval_results = {}
        if isinstance(results[0], (list, tuple)) or (
                isinstance(results[0], np.ndarray) and results[0].ndim == 5):
            num_feats = len(results[0])
            for feat_idx in range(num_feats):
                cur = [r[feat_idx] for r in results]
                eval_results.update(add_prefix(
                    self.pck_evaluate(cur, output_dir, logger),
                    prefix=f'feat_{feat_idx}'))
        else:
            eval_results.update(
                self.pck_evaluate(results, output_dir, logger))
        get_root_logger().info(
            'Results copypaste  ' + ','.join(
                f'{float(v):.2f}' for v in list(eval_results.values())[:2]))
        return eval_results
