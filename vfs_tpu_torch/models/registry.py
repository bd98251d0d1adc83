"""Model registries (counterpart of ``vfs_tpu/models/registry.py``; the
recognizer and localizer registries come with the MMAction2 slice)."""

from ..utils import Registry

BACKBONES = Registry('backbone')
HEADS = Registry('head')
LOSSES = Registry('loss')
TRACKERS = Registry('tracker')
