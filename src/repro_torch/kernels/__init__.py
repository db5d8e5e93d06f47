"""The port's kernels: CUDA C++ for Hopper (``csrc/``), their wrappers and
plain PyTorch versions, and the conv (im2col or implicit GEMM) and matmul
built on them.

Importing this package builds nothing; the CUDA library is built by
``nvcc`` at the first launch on a CUDA tensor (:mod:`.build`).
"""
from . import implicit_conv as _implicit_conv_mod
from . import mls_matmul as _mls_matmul_mod
from . import mls_quantize as _mls_quantize_mod
from .implicit_conv import conv_geometry, conv_pads, implicit_conv_forward, resolve_conv_impl
from .lowbit_conv import (
    LowbitConvFused,
    LowbitMatmulQD,
    lowbit_conv_fused,
    lowbit_matmul_qd,
    qd_gemm,
)
from .mls_matmul import mls_matmul, sg_shapes
from .mls_quantize import mls_quantize, rounding_bytes
from .ref import decode_frac_int, implicit_conv_ref, mls_matmul_ref, quantize_ref

__all__ = [
    "LowbitConvFused",
    "LowbitMatmulQD",
    "conv_geometry",
    "conv_pads",
    "decode_frac_int",
    "implicit_conv_forward",
    "implicit_conv_ref",
    "launch_counts",
    "lowbit_conv_fused",
    "lowbit_matmul_qd",
    "mls_matmul",
    "mls_matmul_ref",
    "mls_quantize",
    "qd_gemm",
    "quantize_ref",
    "reset_launch_counts",
    "resolve_conv_impl",
    "rounding_bytes",
    "sg_shapes",
]

_COUNTERS = (_mls_quantize_mod.LAUNCHES, _mls_matmul_mod.LAUNCHES,
             _implicit_conv_mod.LAUNCHES)


def launch_counts() -> dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by C entry point."""
    return {k: v for counter in _COUNTERS for k, v in counter.items()}


def reset_launch_counts() -> None:
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0
