"""Synthetic CIFAR-like data."""
from .synthetic import CifarIterator, cifar_like_batch, class_pattern

__all__ = ["CifarIterator", "cifar_like_batch", "class_pattern"]
