"""Dataset builder (the ``build_dataset`` of ``vfs_tpu/datasets/builder.py``;
the training loader comes with the SimSiam slice of the port)."""

from ..utils import build_from_cfg
from .registry import DATASETS


def build_dataset(cfg, default_args=None):
    return build_from_cfg(cfg, DATASETS, default_args)
