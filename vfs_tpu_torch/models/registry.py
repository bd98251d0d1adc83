"""Model registries (counterpart of ``vfs_tpu/models/registry.py``)."""

from ..utils import Registry

BACKBONES = Registry('backbone')
HEADS = Registry('head')
LOSSES = Registry('loss')
TRACKERS = Registry('tracker')
RECOGNIZERS = Registry('recognizer')
LOCALIZERS = Registry('localizer')
