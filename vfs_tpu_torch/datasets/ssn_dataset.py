"""SSN proposal dataset (counterpart of ``vfs_tpu/datasets/ssn_dataset.py``;
reference: mmaction/datasets/ssn_dataset.py).

Loads per-video temporal proposals, builds positive/incomplete/background
pools with IoU/IoP thresholds, samples video-centric training proposals
with STPP stage splits, and evaluates detections via regression decode +
temporal NMS + mAP@tIoU.

The proposal sampling draws from ``rng`` (an ``np.random.RandomState``),
by default from the global one, as the JAX package's dataset does.
"""

from __future__ import annotations

import copy
import os.path as osp

import numpy as np

from ..localization.proposal_utils import temporal_iou
from ..localization.ssn_utils import (eval_ap, load_localize_proposal_file,
                                      perform_regression, temporal_nms)
from ..utils import get_root_logger
from .base import BaseDataset
from .registry import DATASETS


def _softmax(x, axis=1):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


class SSNInstance:
    """One temporal proposal (reference ssn_dataset.py:16-80)."""

    def __init__(self, start_frame, end_frame, num_video_frames, label=None,
                 best_iou=0, overlap_self=0):
        self.start_frame = start_frame
        self.end_frame = min(end_frame, num_video_frames)
        self.num_video_frames = num_video_frames
        self.label = label if label is not None else -1
        self.coverage = (end_frame - start_frame) / num_video_frames
        self.best_iou = best_iou
        self.overlap_self = overlap_self
        self.regression_targets = [0.0, 0.0]

    def compute_regression_targets(self, gt_list, positive_threshold):
        ious = [temporal_iou(self.start_frame, self.end_frame,
                             gt.start_frame, gt.end_frame)
                for gt in gt_list]
        best_gt = gt_list[int(np.argmax(ious))]
        proposal_center = (self.start_frame + self.end_frame - 1) / 2
        gt_center = (best_gt.start_frame + best_gt.end_frame - 1) / 2
        proposal_size = self.end_frame - self.start_frame
        gt_size = best_gt.end_frame - best_gt.start_frame
        loc_reg = (gt_center - proposal_center) / proposal_size
        size_reg = np.log(gt_size / proposal_size)
        self.regression_targets = [loc_reg, size_reg]


@DATASETS.register_module()
class SSNDataset(BaseDataset):

    def __init__(self, ann_file, pipeline, train_cfg, test_cfg, data_prefix,
                 test_mode=False, filename_tmpl='img_{:05d}.jpg',
                 start_index=1, modality='RGB', video_centric=True,
                 reg_normalize_constants=None, body_segments=5,
                 aug_segments=(2, 2), aug_ratio=(0.5, 0.5), clip_len=1,
                 frame_interval=1, filter_gt=True, use_regression=True,
                 verbose=False, rng=None):
        self.logger = get_root_logger()
        self.rng = rng
        super().__init__(ann_file, pipeline, data_prefix=data_prefix,
                         test_mode=test_mode, start_index=start_index,
                         modality=modality)
        self.train_cfg = train_cfg
        self.test_cfg = test_cfg
        self.assigner = train_cfg['ssn']['assigner']
        self.sampler = train_cfg['ssn']['sampler']
        self.evaluater = dict(test_cfg['ssn'].get('evaluater', {}))
        self.filename_tmpl = filename_tmpl

        if filter_gt or not test_mode:
            valid = [i for i, vi in enumerate(self.video_infos)
                     if len(vi['gts']) > 0]
            self.video_infos = [self.video_infos[i] for i in valid]

        self.positive_pool = []
        self.background_pool = []
        self.incomplete_pool = []
        self.construct_proposal_pools()

        if reg_normalize_constants is None:
            self.reg_norm_consts = self._compute_reg_normalize_constants()
        else:
            self.reg_norm_consts = np.asarray(reg_normalize_constants)
        self.video_centric = video_centric
        self.body_segments = body_segments
        self.aug_segments = aug_segments
        self.aug_ratio = (aug_ratio, aug_ratio) if isinstance(
            aug_ratio, (int, float)) else tuple(aug_ratio)

        total_ratio = (self.sampler['positive_ratio'] +
                       self.sampler['background_ratio'] +
                       self.sampler['incomplete_ratio'])
        self.positive_per_video = int(
            self.sampler['num_per_video'] *
            (self.sampler['positive_ratio'] / total_ratio))
        self.background_per_video = int(
            self.sampler['num_per_video'] *
            (self.sampler['background_ratio'] / total_ratio))
        self.incomplete_per_video = (self.sampler['num_per_video'] -
                                     self.positive_per_video -
                                     self.background_per_video)
        self.test_interval = test_cfg['ssn']['sampler'].get(
            'test_interval', 6)
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.use_regression = use_regression
        self.logger.info(
            f'SSNDataset: proposal file {self.proposal_file} parsed '
            f'({len(self.positive_pool)} pos / '
            f'{len(self.incomplete_pool)} incomplete / '
            f'{len(self.background_pool)} bg proposals)')

    # -- annotations ------------------------------------------------------
    def load_annotations(self):
        video_infos = []
        if 'normalized_' in self.ann_file:
            self.proposal_file = self.ann_file.replace('normalized_', '')
            if not osp.exists(self.proposal_file):
                raise FileNotFoundError(
                    f'denormalize {self.ann_file} first')
        else:
            self.proposal_file = self.ann_file
        proposal_infos = load_localize_proposal_file(self.proposal_file)
        for video_id, num_frames, gt_boxes, proposal_boxes in \
                proposal_infos:
            frame_dir = video_id
            if self.data_prefix is not None:
                frame_dir = osp.join(self.data_prefix, video_id)
            num_frames = int(num_frames)
            gts = [SSNInstance(int(x[1]), int(x[2]), num_frames,
                               label=int(x[0]), best_iou=1.0)
                   for x in gt_boxes
                   if int(x[2]) > int(x[1]) and int(x[1]) < num_frames]
            proposals = [SSNInstance(int(x[3]), int(x[4]), num_frames,
                                     label=int(x[0]),
                                     best_iou=float(x[1]),
                                     overlap_self=float(x[2]))
                         for x in proposal_boxes
                         if int(x[4]) > int(x[3]) and int(x[3]) < num_frames]
            video_infos.append(dict(frame_dir=frame_dir, video_id=video_id,
                                    total_frames=num_frames, gts=gts,
                                    proposals=proposals))
        return video_infos

    # -- pools ------------------------------------------------------------
    def get_positives(self, gts, proposals, positive_threshold,
                      with_gt=True):
        positives = [p for p in proposals
                     if p.best_iou > positive_threshold]
        if with_gt:
            positives.extend(gts)
        for p in positives:
            p.compute_regression_targets(gts, positive_threshold)
        return positives

    @staticmethod
    def get_negatives(proposals, incomplete_iou_threshold,
                      background_iou_threshold,
                      background_coverage_threshold=0.01,
                      incomplete_overlap_threshold=0.7):
        incompletes, backgrounds = [], []
        for p in proposals:
            if (p.best_iou < incomplete_iou_threshold
                    and p.overlap_self > incomplete_overlap_threshold):
                incompletes.append(p)
            elif (p.best_iou < background_iou_threshold
                  and p.coverage > background_coverage_threshold):
                backgrounds.append(p)
        return incompletes, backgrounds

    def construct_proposal_pools(self):
        a = self.assigner
        for vi in self.video_infos:
            positives = self.get_positives(
                vi['gts'], vi['proposals'], a['positive_iou_threshold'],
                self.sampler['add_gt_as_proposals'])
            self.positive_pool.extend(
                [(vi['video_id'], p) for p in positives])
            incompletes, backgrounds = self.get_negatives(
                vi['proposals'], a['incomplete_iou_threshold'],
                a['background_iou_threshold'],
                a.get('background_coverage_threshold', 0.01),
                a.get('incomplete_overlap_threshold', 0.7))
            self.incomplete_pool.extend(
                [(vi['video_id'], p) for p in incompletes])
            self.background_pool.extend(
                [(vi['video_id'], p) for p in backgrounds])

    def get_all_gts(self):
        gts = {}
        for vi in self.video_infos:
            vid = vi['video_id']
            for gt in vi['gts']:
                gt_info = [gt.start_frame / vi['total_frames'],
                           gt.end_frame / vi['total_frames']]
                gts.setdefault(gt.label - 1, {}).setdefault(
                    vid, []).append(gt_info)
        return gts

    def _compute_reg_normalize_constants(self):
        targets = []
        for vi in self.video_infos:
            positives = self.get_positives(
                vi['gts'], vi['proposals'],
                self.assigner['positive_iou_threshold'], False)
            for p in positives:
                targets.append(list(p.regression_targets))
        if not targets:
            return np.array([[0.0, 0.0], [1.0, 1.0]])
        return np.array((np.mean(targets, axis=0), np.std(targets, axis=0)))

    # -- sampling ----------------------------------------------------------
    def _random(self):
        return self.rng if self.rng is not None else np.random

    def _video_centric_sampling(self, record):
        a = self.assigner
        positives = self.get_positives(
            record['gts'], record['proposals'],
            a['positive_iou_threshold'],
            self.sampler['add_gt_as_proposals'])
        incompletes, backgrounds = self.get_negatives(
            record['proposals'], a['incomplete_iou_threshold'],
            a['background_iou_threshold'],
            a.get('background_coverage_threshold', 0.01),
            a.get('incomplete_overlap_threshold', 0.7))

        def sample(proposal_type, video_id, video_pool, num, dataset_pool):
            if len(video_pool) == 0:
                idx = self._random().choice(len(dataset_pool), num,
                                       replace=len(dataset_pool) < num)
                return [(dataset_pool[x], proposal_type) for x in idx]
            idx = self._random().choice(len(video_pool), num,
                                   replace=len(video_pool) < num)
            return [((video_id, video_pool[x]), proposal_type)
                    for x in idx]

        out = []
        out.extend(sample(0, record['video_id'], positives,
                          self.positive_per_video, self.positive_pool))
        out.extend(sample(1, record['video_id'], incompletes,
                          self.incomplete_per_video, self.incomplete_pool))
        out.extend(sample(2, record['video_id'], backgrounds,
                          self.background_per_video, self.background_pool))
        return out

    def _get_stage(self, proposal, num_frames):
        start_frame = proposal.start_frame
        end_frame = proposal.end_frame
        ori_clip_len = self.clip_len * self.frame_interval
        duration = end_frame - start_frame
        valid_starting = max(0, start_frame -
                             int(duration * self.aug_ratio[0]))
        valid_ending = min(num_frames - ori_clip_len + 1,
                           end_frame - 1 +
                           int(duration * self.aug_ratio[1]))
        valid_starting_length = start_frame - valid_starting - ori_clip_len
        valid_ending_length = (valid_ending - end_frame + 1) - ori_clip_len
        starting_scale = ((valid_starting_length + ori_clip_len + 1) /
                          (duration * self.aug_ratio[0]))
        ending_scale = ((valid_ending_length + ori_clip_len + 1) /
                        (duration * self.aug_ratio[1]))
        aug_start, aug_end = self.aug_segments
        stage_split = [aug_start, aug_start + self.body_segments,
                       aug_start + self.body_segments + aug_end]
        return starting_scale, ending_scale, stage_split

    def prepare_train_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        results['out_proposals'] = self._video_centric_sampling(
            self.video_infos[idx]) if self.video_centric else \
            self._random_sampling()
        scale_factors, types, labels, reg_targets = [], [], [], []
        for (vid, instance), ptype in results['out_proposals']:
            s_scale, e_scale, _ = self._get_stage(
                instance, instance.num_video_frames)
            label = instance.label if ptype in (0, 1) else 0
            scale_factors.append([s_scale, e_scale])
            labels.append(label)
            types.append(ptype)
            rt = instance.regression_targets
            if ptype == 0:
                rt = ((rt[0] - self.reg_norm_consts[0][0]) /
                      self.reg_norm_consts[1][0],
                      (rt[1] - self.reg_norm_consts[0][1]) /
                      self.reg_norm_consts[1][1])
            reg_targets.append(rt)
        results['reg_targets'] = np.array(reg_targets, np.float32)
        results['proposal_scale_factor'] = np.array(scale_factors,
                                                    np.float32)
        results['proposal_labels'] = np.array(labels)
        results['proposal_type'] = np.array(types)
        return self.pipeline(results)

    def _random_sampling(self):
        out = []
        for pool, num, ptype in (
                (self.positive_pool, self.positive_per_video, 0),
                (self.incomplete_pool, self.incomplete_per_video, 1),
                (self.background_pool, self.background_per_video, 2)):
            idx = self._random().choice(len(pool), num,
                                   replace=len(pool) < num)
            out.extend([(pool[x], ptype) for x in idx])
        return out

    def prepare_test_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        proposals = results['proposals']
        num_frames = results['total_frames']
        ori_clip_len = self.clip_len * self.frame_interval
        frame_ticks = np.arange(0, num_frames - ori_clip_len,
                                self.test_interval, dtype=int) + 1
        num_sampled_frames = len(frame_ticks)
        if len(proposals) == 0:
            proposals.append(SSNInstance(0, num_frames - 1, num_frames))
        rel_list, tick_list, scale_list = [], [], []
        for p in proposals:
            rel = (p.start_frame / num_frames, p.end_frame / num_frames)
            rel_dur = rel[1] - rel[0]
            rs_dur = rel_dur * self.aug_ratio[0]
            re_dur = rel_dur * self.aug_ratio[1]
            rel_start = rel[0] - rs_dur
            rel_end = rel[1] + re_dur
            real_start = max(0.0, rel_start)
            real_end = min(1.0, rel_end)
            s_scale = (rel[0] - real_start) / rs_dur
            e_scale = (real_end - rel[1]) / re_dur
            ranges = (real_start, *rel, real_end)
            ticks = (np.array(ranges) * num_sampled_frames).astype(np.int32)
            rel_list.append(rel)
            tick_list.append(ticks)
            scale_list.append((s_scale, e_scale))
        results['relative_proposal_list'] = np.array(rel_list, np.float32)
        results['scale_factor_list'] = np.array(scale_list, np.float32)
        results['proposal_tick_list'] = np.array(tick_list, np.int32)
        results['reg_norm_consts'] = self.reg_norm_consts
        return self.pipeline(results)

    # -- evaluation ----------------------------------------------------------
    def results_to_detections(self, results, top_k=2000, cls_top_k=2,
                              softmax_before_filter=True, **kwargs):
        num_classes = results[0][1].shape[1] - 1
        detections = [dict() for _ in range(num_classes)]
        for idx in range(len(self)):
            video_id = self.video_infos[idx]['video_id']
            rel_props = np.asarray(results[idx][0])
            if rel_props.ndim == 3:
                rel_props = np.squeeze(rel_props, 0)
            action_scores = np.asarray(results[idx][1])
            complete_scores = np.asarray(results[idx][2])
            reg_scores = results[idx][3]
            if reg_scores is None:
                reg_scores = np.zeros(
                    (len(rel_props), num_classes, 2), np.float32)
            reg_scores = np.asarray(reg_scores).reshape(-1, num_classes, 2)
            combined = _softmax(action_scores[:, 1:], 1) * np.exp(
                complete_scores)
            keep_idx = np.argsort(combined.ravel())[-top_k:] \
                if top_k > 0 else np.arange(combined.size)
            for k in keep_idx:
                cls = k % num_classes
                pid = k // num_classes
                new_item = [rel_props[pid, 0], rel_props[pid, 1],
                            combined[pid, cls], reg_scores[pid, cls, 0],
                            reg_scores[pid, cls, 1]]
                if video_id not in detections[cls]:
                    detections[cls][video_id] = np.array([new_item])
                else:
                    detections[cls][video_id] = np.vstack(
                        [detections[cls][video_id], new_item])
        return detections

    def evaluate(self, results, metrics='mAP', eval_dataset='thumos14',
                 **kwargs):
        metrics = metrics if isinstance(metrics, (list, tuple)) else \
            [metrics]
        for metric in metrics:
            if metric != 'mAP':
                raise KeyError(f'metric {metric} is not supported')
        detections = self.results_to_detections(results, **self.evaluater)
        if self.use_regression:
            for cls in range(len(detections)):
                detections[cls] = {k: perform_regression(v)
                                   for k, v in detections[cls].items()}
        nms_thr = self.evaluater.get('nms', 0.5)
        for cls in range(len(detections)):
            detections[cls] = {k: temporal_nms(v, nms_thr)
                               for k, v in detections[cls].items()}
        all_gts = self.get_all_gts()
        for cls in range(len(detections)):
            all_gts.setdefault(cls, dict())
        plain = {}
        for cls in range(len(detections)):
            rows = []
            for vid, dets in detections[cls].items():
                rows.extend([[vid, cls] + x[:3] for x in dets.tolist()])
            plain[cls] = rows
        eval_results = {}
        iou_range = np.arange(0.1, 1.0, 0.1)
        ap_values = eval_ap(plain, all_gts, iou_range)
        for iou, map_iou in zip(iou_range, ap_values.mean(axis=0)):
            eval_results[f'mAP@{iou:.02f}'] = float(map_iou)
        return eval_results
