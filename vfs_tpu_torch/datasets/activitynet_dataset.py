"""ActivityNet temporal-localization dataset (counterpart of
``vfs_tpu/datasets/activitynet_dataset.py``; reference:
mmaction/datasets/activitynet_dataset.py). Host-side."""

from __future__ import annotations

import copy
import json
import os
import os.path as osp

import numpy as np

from .base import BaseDataset
from .registry import DATASETS


@DATASETS.register_module()
class ActivityNetDataset(BaseDataset):
    """JSON annotation database of videos with duration/annotations/
    feature_frame fields; features loaded by the pipeline."""

    def __init__(self, ann_file, pipeline, data_prefix=None,
                 test_mode=False):
        super().__init__(ann_file, pipeline, data_prefix, test_mode)

    def load_annotations(self):
        video_infos = []
        with open(self.ann_file) as f:
            anno_database = json.load(f)
        for video_name in anno_database:
            video_info = anno_database[video_name]
            video_info['video_name'] = video_name
            video_infos.append(video_info)
        return video_infos

    def prepare_test_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['data_prefix'] = self.data_prefix
        return self.pipeline(results)

    prepare_train_frames = prepare_test_frames

    def _import_ground_truth(self):
        ground_truth = {}
        for video_info in self.video_infos:
            video_id = video_info['video_name'][2:]
            gts = []
            for ann in video_info['annotations']:
                t_start, t_end = ann['segment']
                gts.append([t_start, t_end, ann['label']])
            ground_truth[video_id] = np.array(gts)
        return ground_truth

    @staticmethod
    def proposals2json(results):
        """All proposals -> {video_id: proposal_list} (reference
        :117-140)."""
        result_dict = {}
        for result in results:
            video_name = result['video_name']
            result_dict[video_name[2:]] = result['proposal_list']
        return result_dict

    @staticmethod
    def _import_proposals(results):
        proposals = {}
        num_proposals = 0
        for result in results:
            video_id = result['video_name'][2:]
            cur = []
            for proposal in result['proposal_list']:
                t_start, t_end = proposal['segment']
                cur.append([t_start, t_end, proposal['score']])
            proposals[video_id] = np.array(cur)
            num_proposals += len(cur)
        return proposals, num_proposals

    def dump_results(self, results, out, output_format='json'):
        if output_format == 'json':
            result_dict = self.proposals2json(results)
            out_json = dict(version='VERSION 1.3', results=result_dict,
                            external_data={})
            with open(out, 'w') as f:
                json.dump(out_json, f)
        elif output_format == 'csv':
            os.makedirs(out, exist_ok=True)
            header = 'action,start,end,tmin,tmax'
            for result in results:
                video_name, outputs = result
                np.savetxt(osp.join(out, video_name + '.csv'), outputs,
                           header=header, delimiter=',', comments='')
        else:
            raise ValueError(f'unsupported format {output_format}')

    def evaluate(self, results, metrics='AR@AN',
                 max_avg_proposals=100,
                 temporal_iou_thresholds=np.linspace(0.5, 0.95, 10),
                 logger=None):
        """AR@AN / AUC proposal metrics (reference :150-230 via
        core.average_recall_at_avg_proposals)."""
        from ..core.evaluation.proposal import (
            average_recall_at_avg_proposals)
        metrics = metrics if isinstance(metrics, (list, tuple)) else [metrics]
        eval_results = {}
        ground_truth = self._import_ground_truth()
        proposal, num_proposals = self._import_proposals(results)
        for metric in metrics:
            if metric != 'AR@AN':
                raise KeyError(f'metric {metric} is not supported')
            recall, _, _, auc = average_recall_at_avg_proposals(
                ground_truth, proposal, num_proposals,
                max_avg_proposals=max_avg_proposals,
                temporal_iou_thresholds=temporal_iou_thresholds)
            eval_results['auc'] = auc
            for an in (1, 5, 10, 100):
                idx = min(an, recall.shape[1]) - 1
                eval_results[f'AR@{an}'] = float(np.mean(recall[:, idx]))
        return eval_results
