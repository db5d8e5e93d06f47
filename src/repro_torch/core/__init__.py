"""MLS formats, dynamic quantization and the low-bit training config."""
from .formats import (
    FMT_CIFAR,
    FMT_IMAGENET,
    GS_FMT_DEFAULT,
    EMFormat,
    accumulation_bits,
    exponent_fraction,
    pow2,
)
from .lowbit import QuantConfig, fold_in, rounding_generator
from .quantize import (
    GroupSpec,
    broadcast_groups,
    group_reduce_max,
    quantize_elements,
    quantize_group_scale,
)

__all__ = [
    "EMFormat",
    "FMT_CIFAR",
    "FMT_IMAGENET",
    "GS_FMT_DEFAULT",
    "GroupSpec",
    "QuantConfig",
    "accumulation_bits",
    "broadcast_groups",
    "exponent_fraction",
    "fold_in",
    "group_reduce_max",
    "pow2",
    "quantize_elements",
    "quantize_group_scale",
    "rounding_generator",
]
