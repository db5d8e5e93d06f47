"""The paper's CNN zoo and its layer ops."""
from .cnn import CNN, CNNConfig, GoogleNet, ResNet, VGG16, count_ops, init_cnn

__all__ = ["CNN", "CNNConfig", "GoogleNet", "ResNet", "VGG16", "count_ops", "init_cnn"]
