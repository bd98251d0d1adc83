"""Model registries (counterpart of ``vfs_tpu/models/registry.py``; the
recognizer, localizer, head and loss registries come with their slices)."""

from ..utils import Registry

BACKBONES = Registry('backbone')
TRACKERS = Registry('tracker')
