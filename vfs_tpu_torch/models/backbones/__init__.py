from .alexnet import AlexNetV1, AlexNetV2, AlexNetV3
from .resnet import ResNet, ResNetBlockwise
from .resnet3d import (BasicBlock3d, Bottleneck3d, ConvBN3d, ResNet3d,
                       ResNet3dSlowOnly, max_pool_3d)
from .resnet3d_variants import (Block2Plus1d, Conv2Plus1d, CSNBottleneck,
                                ResNet2Plus1d, ResNet3dCSN, ResNet3dSlowFast)
from .resnet_tin import (OffsetNet, ResNetTIN, TemporalInterlace, WeightNet,
                         linear_sampler, tin_shift)
from .resnet_tsm import (ResNetTSM, TSMBasicBlock, TSMBottleneck,
                         temporal_shift)

__all__ = [
    'AlexNetV1', 'AlexNetV2', 'AlexNetV3', 'BasicBlock3d', 'Block2Plus1d',
    'Bottleneck3d', 'Conv2Plus1d', 'ConvBN3d', 'CSNBottleneck',
    'linear_sampler', 'max_pool_3d', 'OffsetNet', 'ResNet', 'ResNet2Plus1d',
    'ResNet3d', 'ResNet3dCSN', 'ResNet3dSlowFast', 'ResNet3dSlowOnly',
    'ResNetBlockwise', 'ResNetTIN', 'ResNetTSM', 'TemporalInterlace',
    'temporal_shift', 'tin_shift', 'TSMBasicBlock', 'TSMBottleneck',
    'WeightNet'
]
