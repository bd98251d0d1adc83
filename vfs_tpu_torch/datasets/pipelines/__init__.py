from .augmentations import (ColorJitter, DeviceAug, Flip, Normalize,
                            RandomGaussianBlur, RandomGrayScale,
                            RandomResizedCrop, Resize)
from .compose import Compose
from .formating import Collect, FormatShape, ToTensor
from .loading import (Clip2Frame, DecordDecode, DecordInit, Frame2Clip,
                      FrameSelector, OpenCVDecode, OpenCVInit, PyAVDecode,
                      PyAVInit, RawFrameDecode, RawFrameDecodeYUV420,
                      SampleFrames, SequentialSampleFrames)

__all__ = [
    'ColorJitter', 'DeviceAug', 'Flip', 'Normalize', 'RandomGaussianBlur',
    'RandomGrayScale', 'RandomResizedCrop', 'Resize', 'Compose', 'Collect',
    'FormatShape', 'ToTensor', 'Clip2Frame', 'DecordDecode', 'DecordInit',
    'Frame2Clip', 'FrameSelector', 'OpenCVDecode', 'OpenCVInit',
    'PyAVDecode', 'PyAVInit', 'RawFrameDecode',
    'RawFrameDecodeYUV420', 'SampleFrames', 'SequentialSampleFrames'
]
