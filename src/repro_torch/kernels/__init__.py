"""The port's kernels: CUDA C++ for Hopper (``csrc/``), their wrappers and
plain PyTorch versions, and the conv (im2col or implicit GEMM) and matmul
built on them.  Every wrapper counts its kernel's launches
(:func:`launch_counts`) and records each launch's geometry, on either
device, for the static verifier (:func:`recorded_specs`).

Importing this package builds nothing; the CUDA library is built by
``nvcc`` at the first launch on a CUDA tensor (:mod:`.build`).
"""
import collections

from . import implicit_conv as _implicit_conv_mod
from . import launch
from . import mls_matmul as _mls_matmul_mod
from . import mls_quantize as _mls_quantize_mod
from . import sabotage as _sabotage_mod
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
    "recorded_specs",
    "reset_launch_counts",
    "resolve_conv_impl",
    "rounding_bytes",
    "sg_shapes",
]

_COUNTERS = (_mls_quantize_mod.LAUNCHES, _mls_matmul_mod.LAUNCHES,
             _implicit_conv_mod.LAUNCHES, _sabotage_mod.LAUNCHES)

# C entry point -> its launch descriptors, from the recorded launch arguments
_LAUNCH_SPECS = {
    "mls_quantize_rows": _mls_quantize_mod.launch_spec_rows,
    "mls_quantize_rows_amax": _mls_quantize_mod.launch_spec_rows_amax,
    "mls_quantize_rows_codes": _mls_quantize_mod.launch_spec_rows_codes,
    "mls_quantize_cols": _mls_quantize_mod.launch_spec_cols,
    "mls_quantize_given_sg": _mls_quantize_mod.launch_spec_given_sg,
    "mls_matmul": _mls_matmul_mod.launch_spec,
    "implicit_conv": _implicit_conv_mod.launch_spec,
    "conv_tensor_scale": _implicit_conv_mod.launch_spec_scale,
    "sabotage_overlap": _sabotage_mod.launch_spec,
}


def launch_counts() -> dict[str, int]:
    """Launches of every CUDA kernel since the last reset, by C entry point."""
    return {k: v for counter in _COUNTERS for k, v in counter.items()}


def reset_launch_counts() -> None:
    """Set every launch count to 0 and forget the recorded launches."""
    for counter in _COUNTERS:
        for k in counter:
            counter[k] = 0
    launch.RECORDED.clear()


def recorded_specs(
    records: collections.Counter | None = None,
) -> list[tuple[launch.LaunchSpec, int]]:
    """``(spec, launches)`` of every distinct launch in ``records`` (default:
    all recorded since the last reset; take the difference of two copies of
    ``launch.RECORDED`` for one stretch of work).  A C entry point may make
    several device launches per call (K1's two passes, K2's scale passes,
    K3's split, K4's pass A): its
    ``launch_spec*`` function returns one spec for each.  A spec recorded on
    the card reads its tile constants from the built library."""
    records = launch.RECORDED if records is None else records
    specs: collections.Counter = collections.Counter()
    for (kernel, device_type, *args), n in records.items():
        built = _LAUNCH_SPECS[kernel](*args, device_type=device_type)
        for spec in (built,) if isinstance(built, launch.LaunchSpec) else built:
            specs[spec] += n
    return list(specs.items())
