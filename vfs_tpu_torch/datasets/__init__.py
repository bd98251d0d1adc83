"""Eval datasets (counterpart of ``vfs_tpu/datasets``). Importing the
package registers every dataset class and pipeline transform, so a
config's ``build_dataset`` resolves without further imports."""

from . import pipelines  # noqa: F401  (register)
from .base import BaseDataset
from .builder import build_dataset
from .davis_dataset import DavisDataset
from .jhmdb_dataset import JHMDBDataset
from .rawframe_dataset import RawframeDataset
from .registry import DATASETS, PIPELINES
from .vip_dataset import VIPDataset

__all__ = [
    'BaseDataset', 'build_dataset', 'DavisDataset', 'JHMDBDataset',
    'RawframeDataset', 'VIPDataset', 'DATASETS', 'PIPELINES'
]
