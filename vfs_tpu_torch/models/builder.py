"""Model builders (counterpart of ``vfs_tpu/models/builder.py``)."""

from ..utils import build_from_cfg
from .registry import (BACKBONES, HEADS, LOCALIZERS, LOSSES, RECOGNIZERS,
                       TRACKERS)


def build_backbone(cfg, default_args=None):
    return build_from_cfg(cfg, BACKBONES, default_args)


def build_head(cfg, default_args=None):
    return build_from_cfg(cfg, HEADS, default_args)


def build_loss(cfg, default_args=None):
    return build_from_cfg(cfg, LOSSES, default_args)


def build_tracker(cfg, train_cfg=None, test_cfg=None):
    return build_from_cfg(cfg, TRACKERS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg))


def build_recognizer(cfg, train_cfg=None, test_cfg=None):
    return build_from_cfg(cfg, RECOGNIZERS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg))


def build_localizer(cfg, train_cfg=None, test_cfg=None):
    return build_from_cfg(cfg, LOCALIZERS,
                          dict(train_cfg=train_cfg, test_cfg=test_cfg))


def build_model(cfg, train_cfg=None, test_cfg=None):
    """Build any registered tracker, recognizer, localizer, head or loss
    from a config dict (trackers, recognizers, then localizers, as in the
    JAX package); an unknown type raises ``KeyError``."""
    obj_type = cfg.get('type')
    if obj_type in TRACKERS:
        return build_tracker(cfg, train_cfg=train_cfg, test_cfg=test_cfg)
    if obj_type in RECOGNIZERS:
        return build_recognizer(cfg, train_cfg=train_cfg, test_cfg=test_cfg)
    if obj_type in LOCALIZERS:
        return build_localizer(cfg, train_cfg=train_cfg, test_cfg=test_cfg)
    if obj_type in HEADS:
        return build_head(cfg)
    if obj_type in LOSSES:
        return build_loss(cfg)
    raise KeyError(f'{obj_type} is not a registered tracker, recognizer, '
                   'localizer, head or loss')
