"""ResNet-20 and its layer ops."""
from .cnn import CNNConfig, ResNet, init_resnet

__all__ = ["CNNConfig", "ResNet", "init_resnet"]
