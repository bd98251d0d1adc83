from .resnet import ResNet, ResNetBlockwise

__all__ = ['ResNet', 'ResNetBlockwise']
