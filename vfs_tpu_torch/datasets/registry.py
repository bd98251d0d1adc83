"""Registries for datasets and pipeline transforms (counterpart of
``vfs_tpu/datasets/registry.py``). Each dataset and transform module
registers its classes at definition time, so importing
``vfs_tpu_torch.datasets`` makes every config-addressable name resolvable.
"""

from ..utils import Registry

DATASETS = Registry('dataset')
PIPELINES = Registry('pipeline')
