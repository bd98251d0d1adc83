"""Video-file dataset for pretraining (counterpart of
``vfs_tpu/datasets/video_dataset.py``; reference:
mmaction/datasets/video_dataset.py:11-133)."""

from __future__ import annotations

import os.path as osp

import numpy as np

from .base import BaseDataset
from .registry import DATASETS


@DATASETS.register_module()
class VideoDataset(BaseDataset):
    """ann_file lines: ``video_path [label ...]`` (Kinetics-400, for
    pretraining and recognition)."""

    def __init__(self, ann_file, pipeline, start_index=0, **kwargs):
        super().__init__(ann_file, pipeline, start_index=start_index,
                         **kwargs)

    def load_annotations(self):
        if self.ann_file.endswith('.json'):
            return self.load_json_annotations()
        video_infos = []
        with open(self.ann_file) as fin:
            for line in fin:
                line_split = line.strip().split()
                if not line_split:
                    continue
                if self.multi_class:
                    if self.num_classes is None:
                        raise ValueError('multi_class needs num_classes')
                    filename = line_split[0]
                    label = np.zeros(self.num_classes, np.float32)
                    label[[int(x) for x in line_split[1:]]] = 1.0
                else:
                    filename = line_split[0]
                    label = int(line_split[1]) if len(line_split) > 1 else 0
                if self.data_prefix is not None:
                    filename = osp.join(self.data_prefix, filename)
                video_infos.append(dict(filename=filename, label=label))
        return video_infos

    def evaluate(self, results, metrics='top_k_accuracy', topk=(1, 5),
                 logger=None):
        """Recognition metrics of ``results`` (one score vector a video,
        in dataset order): ``top{k}_acc`` for each k of ``topk`` and
        ``mean_class_accuracy``."""
        from ..core.evaluation.accuracy import (mean_class_accuracy,
                                                top_k_accuracy)
        metrics = metrics if isinstance(metrics, (list, tuple)) \
            else [metrics]
        gt_labels = [info['label'] for info in self.video_infos]
        eval_results = {}
        for metric in metrics:
            if metric == 'top_k_accuracy':
                accs = top_k_accuracy(results, gt_labels, topk)
                for k, acc in zip(topk, accs):
                    eval_results[f'top{k}_acc'] = acc
            elif metric == 'mean_class_accuracy':
                eval_results['mean_class_accuracy'] = mean_class_accuracy(
                    results, gt_labels)
            else:
                raise KeyError(f'metric {metric} is not supported')
        return eval_results
