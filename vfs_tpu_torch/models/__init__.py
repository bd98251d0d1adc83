from . import backbones  # noqa: F401  (register)
from . import heads  # noqa: F401  (register)
from . import losses  # noqa: F401  (register)
from . import trackers  # noqa: F401  (register)
from .builder import (build_backbone, build_head, build_loss, build_model,
                      build_tracker)
from .registry import BACKBONES, HEADS, LOSSES, TRACKERS

__all__ = [
    'build_backbone', 'build_head', 'build_loss', 'build_model',
    'build_tracker', 'BACKBONES', 'HEADS', 'LOSSES', 'TRACKERS'
]
