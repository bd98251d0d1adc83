from . import backbones  # noqa: F401  (register)
from . import heads  # noqa: F401  (register)
from . import localizers  # noqa: F401  (register)
from . import losses  # noqa: F401  (register)
from . import recognizers  # noqa: F401  (register)
from . import trackers  # noqa: F401  (register)
from .builder import (build_backbone, build_head, build_localizer,
                      build_loss, build_model, build_recognizer,
                      build_tracker)
from .registry import (BACKBONES, HEADS, LOCALIZERS, LOSSES, RECOGNIZERS,
                       TRACKERS)

__all__ = [
    'build_backbone', 'build_head', 'build_localizer', 'build_loss',
    'build_model', 'build_recognizer', 'build_tracker', 'BACKBONES',
    'HEADS', 'LOCALIZERS', 'LOSSES', 'RECOGNIZERS', 'TRACKERS'
]
