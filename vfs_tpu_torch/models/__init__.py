from . import backbones  # noqa: F401  (register)
from . import trackers  # noqa: F401  (register)
from .builder import build_backbone, build_model, build_tracker
from .registry import BACKBONES, TRACKERS

__all__ = [
    'build_backbone', 'build_model', 'build_tracker', 'BACKBONES', 'TRACKERS'
]
