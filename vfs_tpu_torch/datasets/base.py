"""Base dataset (counterpart of ``vfs_tpu/datasets/base.py``; reference:
mmaction/datasets/base.py:14-143)."""

from __future__ import annotations

import copy
import os.path as osp
from abc import ABCMeta, abstractmethod

import numpy as np

from .pipelines.compose import Compose


class BaseDataset(metaclass=ABCMeta):
    """Annotation loading + pipeline application; in training mode a
    sample whose decode raises ``IOError`` is replaced by a random one (the
    reference's retry, base.py:132-143)."""

    def __init__(self, ann_file, pipeline, data_prefix=None, test_mode=False,
                 multi_class=False, num_classes=None, start_index=1,
                 modality='RGB'):
        self.ann_file = ann_file
        self.data_prefix = osp.realpath(data_prefix) if (
            data_prefix is not None and osp.isdir(data_prefix)) \
            else data_prefix
        self.test_mode = test_mode
        self.multi_class = multi_class
        self.num_classes = num_classes
        self.start_index = start_index
        self.modality = modality
        self.pipeline = Compose(pipeline)
        self.video_infos = self.load_annotations()

    @abstractmethod
    def load_annotations(self):
        ...

    def load_json_annotations(self):
        import json
        with open(self.ann_file) as f:
            video_infos = json.load(f)
        path_key = 'frame_dir' if 'frame_dir' in video_infos[0] \
            else 'filename'
        if self.data_prefix is not None:
            for info in video_infos:
                info[path_key] = osp.join(self.data_prefix, info[path_key])
        return video_infos

    def prepare_train_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        return self.pipeline(results)

    def prepare_test_frames(self, idx):
        results = copy.deepcopy(self.video_infos[idx])
        results['modality'] = self.modality
        results['start_index'] = self.start_index
        return self.pipeline(results)

    def __len__(self):
        return len(self.video_infos)

    def __getitem__(self, idx):
        if self.test_mode:
            return self.prepare_test_frames(idx)
        while True:
            try:
                return self.prepare_train_frames(idx)
            except (IOError, OSError):
                idx = np.random.randint(len(self))
