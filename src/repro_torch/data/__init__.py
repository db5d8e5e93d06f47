"""Synthetic data: CIFAR-like images and LM token streams."""
from .synthetic import (
    CifarIterator,
    LMIterator,
    cifar_like_batch,
    class_pattern,
    lm_batch,
    make_lm_iterator,
    markov_tokens,
)

__all__ = ["CifarIterator", "LMIterator", "cifar_like_batch", "class_pattern", "lm_batch",
           "make_lm_iterator", "markov_tokens"]
