"""Datasets (counterpart of ``vfs_tpu/datasets``). Importing the package
registers every dataset class and pipeline transform, so a config's
``build_dataset`` resolves without further imports."""

from . import pipelines  # noqa: F401  (register)
from .activitynet_dataset import ActivityNetDataset
from .base import BaseDataset
from .builder import (DataLoader, EpochSampler, build_dataloader,
                      build_dataset, collate)
from .dataset_wrappers import RepeatDataset
from .davis_dataset import DavisDataset
from .image_dataset import ImageDataset
from .jhmdb_dataset import JHMDBDataset
from .rawframe_dataset import RawframeDataset
from .registry import DATASETS, PIPELINES
from .ssn_dataset import SSNDataset, SSNInstance
from .video_dataset import VideoDataset
from .vip_dataset import VIPDataset

__all__ = [
    'ActivityNetDataset', 'BaseDataset', 'DataLoader', 'EpochSampler', 'build_dataloader',
    'build_dataset', 'collate', 'RepeatDataset', 'DavisDataset',
    'ImageDataset', 'JHMDBDataset', 'RawframeDataset', 'SSNDataset',
    'SSNInstance', 'VideoDataset', 'VIPDataset',
    'DATASETS', 'PIPELINES'
]
