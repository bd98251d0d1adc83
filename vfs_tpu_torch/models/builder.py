"""Model builders (counterpart of ``vfs_tpu/models/builder.py``)."""

from ..utils import build_from_cfg
from .registry import BACKBONES, TRACKERS


def build_backbone(cfg, default_args=None):
    return build_from_cfg(cfg, BACKBONES, default_args)


def build_tracker(cfg, train_cfg=None, test_cfg=None):
    return build_from_cfg(cfg, TRACKERS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg))


def build_model(cfg, train_cfg=None, test_cfg=None):
    """Build a registered model from a config dict (trackers only in this
    slice of the port)."""
    obj_type = cfg.get('type')
    if obj_type in TRACKERS:
        return build_tracker(cfg, train_cfg=train_cfg, test_cfg=test_cfg)
    raise KeyError(f'{obj_type} is not a registered tracker')
