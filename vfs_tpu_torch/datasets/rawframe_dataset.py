"""Rawframe dataset (counterpart of ``vfs_tpu/datasets/rawframe_dataset.py``;
reference: mmaction/datasets/rawframe_dataset.py)."""

from __future__ import annotations

import copy
import os.path as osp

import numpy as np

from .base import BaseDataset
from .registry import DATASETS


@DATASETS.register_module()
class RawframeDataset(BaseDataset):
    """Frame-directory dataset.

    ann_file lines: ``frame_dir total_frames label[s]`` (or with offset:
    ``frame_dir offset total_frames label``)."""

    def __init__(self, ann_file, pipeline, data_prefix=None, test_mode=False,
                 filename_tmpl='img_{:05}.jpg', with_offset=False,
                 multi_class=False, num_classes=None, start_index=1,
                 modality='RGB'):
        self.filename_tmpl = filename_tmpl
        self.with_offset = with_offset
        super().__init__(ann_file, pipeline, data_prefix, test_mode,
                         multi_class, num_classes, start_index, modality)

    def load_annotations(self):
        if self.ann_file.endswith('.json'):
            return self.load_json_annotations()
        video_infos = []
        with open(self.ann_file) as fin:
            for line in fin:
                line_split = line.strip().split()
                if not line_split:
                    continue
                video_info = {}
                idx = 0
                frame_dir = line_split[idx]
                if self.data_prefix is not None:
                    frame_dir = osp.join(self.data_prefix, frame_dir)
                video_info['frame_dir'] = frame_dir
                idx += 1
                if self.with_offset:
                    video_info['offset'] = int(line_split[idx])
                    video_info['total_frames'] = int(line_split[idx + 1])
                    idx += 2
                else:
                    video_info['total_frames'] = int(line_split[idx])
                    idx += 1
                label = [int(x) for x in line_split[idx:]]
                if not label:
                    label = [0]
                if self.multi_class:
                    assert self.num_classes is not None
                    onehot = np.zeros(self.num_classes, np.float32)
                    onehot[label] = 1.0
                    video_info['label'] = onehot
                else:
                    assert len(label) == 1
                    video_info['label'] = label[0]
                video_infos.append(video_info)
        return video_infos

    def _prepare(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['filename_tmpl'] = self.filename_tmpl
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        return self.pipeline(results)

    def prepare_train_frames(self, idx):
        return self._prepare(idx)

    def prepare_test_frames(self, idx):
        return self._prepare(idx)
