from .augmentations import (RGB2LAB, CenterCrop, ColorJitter, DeviceAug,
                            Flip, Fuse, Grid, HidePatch, Image2Patch,
                            MultiGroupCrop, MultiScaleCrop, Normalize,
                            PhotoMetricDistortion, RandomAffine,
                            RandomChoiceRotate, RandomCrop, RandomErasing,
                            RandomGaussianBlur, RandomGrayScale,
                            RandomResizedCrop, Resize, TenCrop, ThreeCrop)
from .compose import Compose
from .formating import (Collect, FormatShape, ImageToTensor, ToDataContainer,
                        ToTensor, Transpose)
from .loading import (AppendFrames, Clip2Frame, DecordDecode, DecordInit,
                      DenseSampleFrames, DuplicateFrames, Frame2Clip,
                      FrameSelector, GenerateLocalizationLabels,
                      LoadLocalizationFeature, LoadProposals, OpenCVDecode,
                      OpenCVInit, PyAVDecode, PyAVInit, RawFrameDecode,
                      RawFrameDecodeYUV420, RawImageDecode, SampleFrames,
                      SampleProposalFrames, SequentialSampleFrames,
                      UntrimmedSampleFrames)

__all__ = [
    'CenterCrop', 'ColorJitter', 'DeviceAug', 'Flip', 'Fuse',
    'MultiGroupCrop', 'MultiScaleCrop', 'Normalize', 'RandomCrop',
    'RandomGaussianBlur', 'RandomGrayScale', 'RandomResizedCrop', 'Resize',
    'TenCrop', 'ThreeCrop', 'RGB2LAB', 'PhotoMetricDistortion',
    'RandomErasing', 'Grid', 'Image2Patch', 'HidePatch', 'RandomAffine',
    'RandomChoiceRotate', 'Compose', 'Collect', 'FormatShape',
    'ImageToTensor', 'ToDataContainer', 'ToTensor', 'Transpose',
    'AppendFrames', 'Clip2Frame', 'DecordDecode', 'DecordInit',
    'DenseSampleFrames', 'DuplicateFrames', 'Frame2Clip', 'FrameSelector',
    'GenerateLocalizationLabels', 'LoadLocalizationFeature', 'LoadProposals',
    'SampleProposalFrames', 'OpenCVDecode', 'OpenCVInit', 'PyAVDecode', 'PyAVInit', 'RawFrameDecode',
    'RawFrameDecodeYUV420', 'RawImageDecode', 'SampleFrames',
    'SequentialSampleFrames', 'UntrimmedSampleFrames'
]
