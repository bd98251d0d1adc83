from .augmentations import Flip, Normalize, Resize
from .compose import Compose
from .formating import Collect, FormatShape, ToTensor
from .loading import RawFrameDecode, SequentialSampleFrames

__all__ = [
    'Flip', 'Normalize', 'Resize', 'Compose', 'Collect', 'FormatShape',
    'ToTensor', 'RawFrameDecode', 'SequentialSampleFrames'
]
