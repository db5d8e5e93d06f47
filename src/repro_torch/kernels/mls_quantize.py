"""MLS dynamic quantization of a 2-D GEMM operand (paper Alg. 2).

:func:`mls_quantize` returns packed ``sign|exp|man`` uint8 codes, the group
scales in the compact layout of the grouping (paper Table IV) and the
tensor scale.  On a CUDA tensor it launches the kernels of
``csrc/mls_quantize.cu``: the row-group kernel (groupings "nc", "n"; the
TPU's ``_kernel_rowwise``) or the given-scale kernel ("c", "none"; the
TPU's ``_kernel_given_sg``).  On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.quantize_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.core.formats import EMFormat, GS_FMT_DEFAULT
from repro_torch.core.lowbit import GROUPINGS
from repro_torch.core.quantize import quantize_group_scale

from . import build
from .ref import quantize_ref

__all__ = ["LAUNCHES", "mls_quantize", "rounding_bytes"]

# Launches of each CUDA kernel, counted where the kernel is launched.
LAUNCHES = {"mls_quantize_rows": 0, "mls_quantize_given_sg": 0}

_DETERMINISTIC_BYTE = 127  # r = -1/512: the TPU kernel's nearest rounding


def rounding_bytes(
    shape: tuple[int, ...], generator: torch.Generator | None, device: torch.device
) -> torch.Tensor:
    """The uint8 stochastic-rounding source of one operand: uniform draws
    from ``generator``, or the constant 127 when rounding is deterministic."""
    if generator is None:
        return torch.full(shape, _DETERMINISTIC_BYTE, dtype=torch.uint8, device=device)
    return torch.randint(0, 256, shape, generator=generator, dtype=torch.uint8,
                         device=device)


def _fmt_args(fmt: EMFormat, gs_fmt: EMFormat) -> tuple[int, int, int, int, int]:
    return fmt.e, fmt.m, fmt.e_min, gs_fmt.m, max(gs_fmt.e_min, -120)


def mls_quantize(
    x: torch.Tensor,
    fmt: EMFormat,
    k_block: int = 128,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    r_u8: torch.Tensor | None = None,
    grouping: str = "nc",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize a contiguous float32 ``(M, K)`` operand to packed MLS codes.

    Returns ``(codes uint8 (M, K), s_g f32, s_t f32 scalar)`` with ``s_g``
    in the compact layout of ``grouping``: (M, K/k_block) for "nc",
    (1, K/k_block) for "c", (M, 1) for "n", (1, 1) for "none".  ``r_u8``
    (M, K) uint8 is the rounding source; ``None`` means the constant 127.
    ``K`` must be a multiple of ``k_block``.
    """
    if grouping not in GROUPINGS:
        raise ValueError(f"unknown grouping {grouping!r}; expected one of {GROUPINGS}")
    if fmt.element_bits > 8:
        raise ValueError(f"{fmt} does not fit an 8-bit code")
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"mls_quantize takes a contiguous float32 (M, K) tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    M, K = x.shape
    if K % k_block:
        raise ValueError(f"mls_quantize: K={K} is not a multiple of k_block={k_block}; "
                         f"pad the operand (qd_gemm does) or pick a dividing k_block")
    if r_u8 is None:
        r_u8 = rounding_bytes((M, K), None, x.device)
    if (r_u8.shape != x.shape or r_u8.dtype != torch.uint8 or r_u8.device != x.device
            or not r_u8.is_contiguous()):
        raise ValueError("r_u8 must be a contiguous uint8 tensor of x's shape and device")
    if x.device.type == "cpu":
        return quantize_ref(x, fmt, k_block, gs_fmt, r_u8, grouping)
    if x.device.type != "cuda":
        raise ValueError(f"mls_quantize runs on cuda or cpu tensors, not {x.device}")

    lib = build.library()
    s_t = torch.amax(x.abs())
    s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
    codes = torch.empty((M, K), dtype=torch.uint8, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    fa = _fmt_args(fmt, gs_fmt)
    if grouping in ("nc", "n"):
        width = k_block if grouping == "nc" else K
        s_g = torch.empty((M, K // width), dtype=torch.float32, device=x.device)
        build.check(lib.mls_quantize_rows(
            x.data_ptr(), r_u8.data_ptr(), s_t.data_ptr(), codes.data_ptr(),
            s_g.data_ptr(), M, K, width, *fa, stream), "mls_quantize_rows")
        LAUNCHES["mls_quantize_rows"] += 1
        return codes, s_g, s_t
    # "c" / "none": compact scales computed ahead (the "c" group max crosses
    # all rows), with the same exact group-scale math
    if grouping == "c":
        s_r = x.abs().amax(dim=0).reshape(K // k_block, k_block).amax(dim=1)
        s_g = quantize_group_scale(s_r / s_t, gs_fmt)[0].reshape(1, -1).contiguous()
    else:
        s_g = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    build.check(lib.mls_quantize_given_sg(
        x.data_ptr(), r_u8.data_ptr(), s_t.data_ptr(), s_g.data_ptr(),
        codes.data_ptr(), M, K, k_block, 1 if grouping == "c" else 0, *fa, stream),
        "mls_quantize_given_sg")
    LAUNCHES["mls_quantize_given_sg"] += 1
    return codes, s_g, s_t
