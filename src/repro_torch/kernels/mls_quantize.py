"""MLS dynamic quantization of a 2-D GEMM operand (paper Alg. 2).

:func:`mls_quantize` returns packed ``sign|exp|man`` uint8 codes, the group
scales in the compact layout of the grouping (paper Table IV) and the
tensor scale.  On a CUDA tensor it calls one C entry point of
``csrc/mls_quantize.cu`` and launches no PyTorch op but ``torch.empty``:
the row-group kernel K1 (groupings "nc", "n"; the TPU's
``_kernel_rowwise``), two passes that also take the tensor scale, or K2
(groupings "c", "none"; the TPU's ``_kernel_given_sg``), whose column
passes make the tensor and group scales on the card before its code pass.
On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.quantize_ref`.  :func:`quantize_given_scales`
is K2's code pass alone, for callers that bring their scales (the
implicit conv's code reuse).  Given a process ``group`` (tensor
parallelism: ``x`` is one rank's slice of an operand split over the
group's ranks), K1 runs as two C calls, its pass A
(``mls_quantize_rows_amax``) and its pass B (``mls_quantize_rows_codes``),
with an all-reduce MAX of the slice's max |x| between them, so that the
tensor scale is the unsharded operand's.  On a fake operand (a dry
run's trace, ``launch.shape_only``) K1's entries allocate what the card's
launch allocates and record it as the card's (``launch.record``), and
call no kernel and count no launch; K2's refuse one.
:func:`launch_spec_rows`, :func:`launch_spec_rows_amax`,
:func:`launch_spec_rows_codes`, :func:`launch_spec_cols` and
:func:`launch_spec_given_sg` describe the launches for the static
verifier.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.core.formats import EMFormat, GS_FMT_DEFAULT
from repro_torch.core.lowbit import GROUPINGS

from . import autotune, build, launch
from .launch import LaunchSpec, Operand
from .ref import element_codes_ref, quantize_ref

__all__ = [
    "LAUNCHES",
    "TILE",
    "col_tiling",
    "launch_spec_cols",
    "launch_spec_given_sg",
    "launch_spec_rows",
    "launch_spec_rows_amax",
    "launch_spec_rows_codes",
    "mls_quantize",
    "quantize_launch",
    "quantize_given_scales",
    "quantize_rows_split",
    "rounding_bytes",
    "rows_amax",
    "rows_codes",
]

# Launches of each kernel, counted where its C entry point is called: K1
# ("mls_quantize_rows"), K1's two split entries under their own names, and
# K2 (both of its entry points, mls_quantize_cols and
# mls_quantize_given_sg, under K2's name "mls_quantize_given_sg").
LAUNCHES = {"mls_quantize_rows": 0, "mls_quantize_rows_amax": 0, "mls_quantize_rows_codes": 0,
            "mls_quantize_given_sg": 0}

# csrc/mls_quantize.cu's launch constants (mls_quantize_constants)
TILE = {"kThreads": 256, "kWarpGroupMax": 1024, "kAmaxBlocks": 2 * 132,
        "kAmaxChunk": 256 * 16, "kRowBlocks": 8 * 132, "kColAmaxBlocks": 2 * 132,
        "kCodeBlocks": 8 * 132}

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
    config: autotune.BlockConfig | None = None,
    exact_nearest: bool = False,
    group=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize a contiguous float32 ``(M, K)`` operand to packed MLS codes.

    Returns ``(codes uint8 (M, K), s_g f32, s_t f32 scalar)`` with ``s_g``
    in the compact layout of ``grouping``: (M, K/k_block) for "nc",
    (1, K/k_block) for "c", (M, 1) for "n", (1, 1) for "none".  ``r_u8``
    (M, K) uint8 is the rounding source; ``None`` means the constant 127.
    ``K`` must be a multiple of ``k_block``.  ``config`` (default: the
    tile cache's choice for this (M, K) operand on this device,
    :func:`autotune.resolve_block_config`) picks K1's pass-B variant and
    pass-A grid; every choice gives the same bits.  ``exact_nearest``
    (K1's groupings "nc" and "n", no ``r_u8``) rounds to nearest with no
    offset and reads no bytes: ``quantize_ref`` without bytes, the JAX
    package's ``core.mls_quantize`` without a key, where the constant byte
    127 is its Pallas kernel's nearest.  ``group`` (K1's groupings): ``x``
    is one rank's slice of an operand split over the ranks of this
    ``torch.distributed`` process group, and its tensor scale is made from
    the max |x| over every slice (the module docstring); every rank of the
    group must call this together.
    """
    if grouping not in GROUPINGS:
        raise ValueError(f"unknown grouping {grouping!r}; expected one of {GROUPINGS}")
    if group is not None and (grouping not in ("nc", "n") or exact_nearest):
        raise ValueError(f"a sharded operand takes K1's groupings 'nc' or 'n' with rounding "
                         f"bytes, not {grouping!r} (exact_nearest={exact_nearest}): K2's "
                         f"column groups would span the ranks")
    if fmt.element_bits > 8:
        raise ValueError(f"{fmt} does not fit an 8-bit code")
    if x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"mls_quantize takes a contiguous float32 (M, K) tensor, got "
                         f"{x.dtype} {tuple(x.shape)} contiguous={x.is_contiguous()}")
    M, K = x.shape
    if K % k_block:
        raise ValueError(f"mls_quantize: K={K} is not a multiple of k_block={k_block}; "
                         f"pad the operand (qd_gemm does) or pick a dividing k_block")
    if exact_nearest:
        if r_u8 is not None or grouping not in ("nc", "n"):
            raise ValueError("exact_nearest takes no rounding bytes and K1's groupings "
                             "'nc' or 'n'")
    elif r_u8 is None:
        r_u8 = rounding_bytes((M, K), None, x.device)
    if r_u8 is not None and (r_u8.shape != x.shape or r_u8.dtype != torch.uint8
                             or r_u8.device != x.device or not r_u8.is_contiguous()):
        raise ValueError("r_u8 must be a contiguous uint8 tensor of x's shape and device")
    if config is None:
        config = autotune.resolve_block_config("quantize", (M, K), fmt, grouping,
                                               k_block=k_block, **launch.plan_for(x))
    if group is not None:
        return quantize_rows_split(x, fmt, k_block, gs_fmt, r_u8, grouping, config,
                                   functools.partial(_all_reduce_max, group=group))
    fake = launch.shape_only(x, r_u8)
    if x.device.type == "cpu" and not fake:
        kernel, args = quantize_launch(M, K, k_block, grouping, config)  # what the card runs
        launch.record(kernel, "cpu", *args)
        with launch.plain_version():
            return quantize_ref(x, fmt, k_block, gs_fmt, r_u8, grouping)
    if x.device.type != "cuda" and not fake:
        raise ValueError(f"mls_quantize runs on cuda or cpu tensors, not {x.device}")

    if x.numel() == 0:
        raise ValueError("mls_quantize takes a non-empty operand (its tensor scale is a max)")
    if grouping in ("nc", "n"):
        _, (_, _, width, variant, parts) = quantize_launch(M, K, k_block, grouping, config)
        dev = x.device
        partials = torch.empty((parts,), dtype=torch.float32, device=dev)
        s_t = torch.empty((), dtype=torch.float32, device=dev)
        codes = torch.empty((M, K), dtype=torch.uint8, device=dev)
        s_g = torch.empty((M, K // width), dtype=torch.float32, device=dev)
        if not fake:
            build.check(build.library().mls_quantize_rows(
                x.data_ptr(), None if r_u8 is None else r_u8.data_ptr(), partials.data_ptr(),
                parts, s_t.data_ptr(), codes.data_ptr(), s_g.data_ptr(), M, K, width,
                _ROW_VARIANTS.index(variant), *_fmt_args(fmt, gs_fmt),
                torch.cuda.current_stream(dev).cuda_stream), "mls_quantize_rows")
            LAUNCHES["mls_quantize_rows"] += 1
        launch.record("mls_quantize_rows", "cuda", M, K, width, variant, parts)
        return codes, s_g, s_t
    return _quantize_cols(x, fmt, k_block if grouping == "c" else K, gs_fmt, r_u8)


def quantize_rows_split(
    x: torch.Tensor,
    fmt: EMFormat,
    k_block: int = 128,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    r_u8: torch.Tensor | None = None,
    grouping: str = "nc",
    config: autotune.BlockConfig | None = None,
    reduce_amax=None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1 in two C calls: pass A (``mls_quantize_rows_amax``: the partial
    maxima and their max, ``x``'s max |x|, a (1,) fp32 tensor), then
    ``reduce_amax`` of that max (in place or returned: the max over every
    slice of a sharded operand; None keeps ``x``'s own), then pass B
    (``mls_quantize_rows_codes``) against it.  The arguments and results are
    :func:`mls_quantize`'s (groupings "nc" and "n"; ``config`` K1's variant
    and pass-A grid); with ``x``'s own max, its bits.  On a CPU tensor the
    plain version, ``quantize_ref`` with the given max."""
    if grouping not in ("nc", "n"):
        raise ValueError(f"K1's split entries take groupings 'nc' or 'n', not {grouping!r}")
    if (x.ndim != 2 or x.dtype != torch.float32 or not x.is_contiguous()
            or x.shape[1] % k_block):
        raise ValueError(f"quantize_rows_split takes a contiguous float32 (M, K) tensor with "
                         f"K a multiple of k_block={k_block}, got {x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    if r_u8 is None:
        r_u8 = rounding_bytes((M, K), None, x.device)
    if (r_u8.shape != x.shape or r_u8.dtype != torch.uint8 or r_u8.device != x.device
            or not r_u8.is_contiguous()):
        raise ValueError("r_u8 must be a contiguous uint8 tensor of x's shape and device")
    if config is None:
        config = autotune.resolve_block_config("quantize", (M, K), fmt, grouping,
                                               k_block=k_block, **launch.plan_for(x))
    _, (_, _, width, variant, parts) = quantize_launch(M, K, k_block, grouping, config)
    reduce_amax = reduce_amax or (lambda a: a)
    fake = launch.shape_only(x, r_u8)
    if x.device.type == "cpu" and not fake:
        launch.record("mls_quantize_rows_amax", "cpu", M * K, parts)
        launch.record("mls_quantize_rows_codes", "cpu", M, K, width, variant, 1)
        with launch.plain_version():
            amax = reduce_amax(x.abs().amax().reshape(1))
            return quantize_ref(x, fmt, k_block, gs_fmt, r_u8, grouping, amax=amax)
    if (x.device.type != "cuda" and not fake) or x.numel() == 0:
        raise ValueError(f"quantize_rows_split runs on non-empty cuda or cpu tensors, not "
                         f"{x.device} {tuple(x.shape)}")
    amax = reduce_amax(rows_amax(x, parts))
    return rows_codes(x, r_u8, amax, fmt, width, variant, gs_fmt)


def rows_amax(x: torch.Tensor, parts: int) -> torch.Tensor:
    """K1's split pass A on the card (``mls_quantize_rows_amax``): ``x``'s
    max |x|, a (1,) fp32 tensor, through ``parts`` partial maxima (on a
    fake ``x``, unwritten and uncounted: recorded only)."""
    M, K = x.shape
    partials = torch.empty((parts,), dtype=torch.float32, device=x.device)
    amax = torch.empty((1,), dtype=torch.float32, device=x.device)
    if not launch.shape_only(x):
        build.check(build.library().mls_quantize_rows_amax(
            x.data_ptr(), partials.data_ptr(), parts, amax.data_ptr(), M * K,
            torch.cuda.current_stream(x.device).cuda_stream), "mls_quantize_rows_amax")
        LAUNCHES["mls_quantize_rows_amax"] += 1
    launch.record("mls_quantize_rows_amax", "cuda", M * K, parts)
    return amax


def rows_codes(x: torch.Tensor, r_u8: torch.Tensor, amax: torch.Tensor, fmt: EMFormat,
               width: int, variant: str, gs_fmt: EMFormat = GS_FMT_DEFAULT
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's split pass B on the card (``mls_quantize_rows_codes``): the
    codes, group scales (``width``-wide groups, ``variant``) and tensor
    scale of ``x`` against the max in ``amax`` (a (1,) fp32 tensor; on fake
    operands, unwritten and uncounted: recorded only)."""
    M, K = x.shape
    dev = x.device
    s_t = torch.empty((), dtype=torch.float32, device=dev)
    codes = torch.empty((M, K), dtype=torch.uint8, device=dev)
    s_g = torch.empty((M, K // width), dtype=torch.float32, device=dev)
    if not launch.shape_only(x, r_u8, amax):
        build.check(build.library().mls_quantize_rows_codes(
            x.data_ptr(), r_u8.data_ptr(), amax.data_ptr(), 1, s_t.data_ptr(),
            codes.data_ptr(), s_g.data_ptr(), M, K, width, _ROW_VARIANTS.index(variant),
            *_fmt_args(fmt, gs_fmt), torch.cuda.current_stream(dev).cuda_stream),
            "mls_quantize_rows_codes")
        LAUNCHES["mls_quantize_rows_codes"] += 1
    launch.record("mls_quantize_rows_codes", "cuda", M, K, width, variant, 1)
    return codes, s_g, s_t


def _all_reduce_max(amax: torch.Tensor, group) -> torch.Tensor:
    """The max of a (1,) fp32 tensor over the ranks of ``group``, in place."""
    import torch.distributed as dist

    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    return amax


def _vec(K: int, group_width: int, *tensors: torch.Tensor) -> int:
    """1 when K2's passes take float4 / 32-bit accesses: widths that are
    multiples of 4 and aligned operands (x 16 bytes, bytes 4)."""
    aligned = all(t.data_ptr() % (16 if t.dtype == torch.float32 else 4) == 0
                  for t in tensors)
    return int(K % 4 == 0 and group_width % 4 == 0 and aligned)


def _quantize_cols(x: torch.Tensor, fmt: EMFormat, group_width: int, gs_fmt: EMFormat,
                   r_u8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K2 with its scales made on the card ("c": ``group_width`` =
    k_block; "none": ``group_width`` = K): one C call, outputs and scratch
    from ``torch.empty``."""
    launch.refuse_shape_only("K2 (mls_quantize_cols)", x, r_u8)
    M, K = x.shape
    dev = x.device
    G = K // group_width
    codes = torch.empty((M, K), dtype=torch.uint8, device=dev)
    vec = _vec(K, group_width, x, r_u8, codes)
    parts = _cols_partials(M, K, group_width, vec, TILE)
    part = torch.empty((parts,), dtype=torch.float32, device=dev)
    gmax = torch.empty((G,), dtype=torch.float32, device=dev) if G > 1 else None
    s_t = torch.empty((), dtype=torch.float32, device=dev)
    s_g = torch.empty((1, G), dtype=torch.float32, device=dev)
    build.check(build.library().mls_quantize_cols(
        x.data_ptr(), r_u8.data_ptr(), part.data_ptr(), parts,
        gmax.data_ptr() if gmax is not None else None, s_t.data_ptr(), codes.data_ptr(),
        s_g.data_ptr(), M, K, group_width, vec, *_fmt_args(fmt, gs_fmt),
        torch.cuda.current_stream(dev).cuda_stream), "mls_quantize_cols")
    LAUNCHES["mls_quantize_given_sg"] += 1
    launch.record("mls_quantize_cols", "cuda", M, K, group_width, vec)
    return codes, s_g, s_t


def quantize_given_scales(
    x: torch.Tensor,
    fmt: EMFormat,
    s_t: torch.Tensor,
    s_g: torch.Tensor,
    k_block: int,
    r_u8: torch.Tensor,
) -> torch.Tensor:
    """uint8 codes of a contiguous float32 ``(M, K)`` operand against the
    given tensor scale ``s_t`` (a scalar) and compact group scales ``s_g``:
    (1, K/k_block), one per ``k_block`` columns ("c"), or (1, 1) ("none").
    ``r_u8`` (M, K) uint8 is the rounding source.  On CUDA this is the
    given-scale kernel; on the CPU its plain version."""
    M, K = x.shape
    if s_t.numel() != 1:
        raise ValueError("the tensor scale must be a scalar")
    if K % k_block or tuple(s_g.shape) not in ((1, 1), (1, K // k_block)):
        raise ValueError(f"group scales {tuple(s_g.shape)} do not fit K={K}, "
                         f"k_block={k_block}")
    sg_stride = 0 if s_g.numel() == 1 else 1
    launch.refuse_shape_only("K2 (mls_quantize_given_sg)", x, r_u8, s_t, s_g)
    if x.device.type == "cpu":
        launch.record("mls_quantize_given_sg", "cpu", M, K, k_block, sg_stride,
                      int(K % 4 == 0 and k_block % 4 == 0))
        per_col = s_g.repeat_interleave(k_block, dim=1) if s_g.numel() > 1 else s_g
        with launch.plain_version():
            return element_codes_ref(x, r_u8, s_t * per_col, fmt)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_given_scales runs on cuda or cpu tensors, not {x.device}")
    if (x.dtype != torch.float32 or not x.is_contiguous() or r_u8.shape != x.shape
            or r_u8.dtype != torch.uint8 or not r_u8.is_contiguous()):
        raise ValueError("quantize_given_scales takes a contiguous float32 x and a "
                         "contiguous uint8 r_u8 of its shape")
    if any(t.device != x.device or t.dtype != torch.float32 for t in (s_t, s_g)):
        raise ValueError("scales must be float32 tensors on x's device")
    s_t, s_g = s_t.contiguous(), s_g.contiguous()
    codes = torch.empty((M, K), dtype=torch.uint8, device=x.device)
    vec = _vec(K, k_block, x, r_u8, codes)
    build.check(build.library().mls_quantize_given_sg(
        x.data_ptr(), r_u8.data_ptr(), s_t.data_ptr(), s_g.data_ptr(),
        codes.data_ptr(), M, K, k_block, sg_stride, vec,
        *_fmt_args(fmt, GS_FMT_DEFAULT), torch.cuda.current_stream(x.device).cuda_stream),
        "mls_quantize_given_sg")
    LAUNCHES["mls_quantize_given_sg"] += 1
    launch.record("mls_quantize_given_sg", "cuda", M, K, k_block, sg_stride, vec)
    return codes


# ---------------------------------------------------------------------------
# Launch descriptors
# ---------------------------------------------------------------------------
_ROW_VARIANTS = ("warp", "block")  # mls_quantize_rows' variant codes


def quantize_launch(M: int, K: int, k_block: int, grouping: str,
                    config: autotune.BlockConfig | None = None) -> tuple[str, tuple]:
    """The C entry point :func:`mls_quantize` calls on an (M, K) operand and
    its launch arguments (those of :func:`launch_spec_rows` /
    :func:`launch_spec_cols`), for operands whose allocations are aligned
    (as ``torch.empty``'s are).  K1's carry ``config``'s variant and pass-A
    grid (default: today's rule, ``autotune.default_block_config``);
    raises on a config K1 or K2 cannot launch."""
    if grouping in ("nc", "n"):
        width = k_block if grouping == "nc" else K
        if config is None:
            variant = "warp" if width <= TILE["kWarpGroupMax"] else "block"
            parts = _amax_blocks(M * K, TILE)
        else:
            variant, parts = config.variant, config.amax_blocks
        if variant not in _ROW_VARIANTS or (variant == "warp" and width > TILE["kWarpGroupMax"]):
            raise ValueError(f"K1 cannot run variant {variant!r} on {width}-wide groups "
                             f"(a warp takes at most {TILE['kWarpGroupMax']})")
        if not 1 <= parts <= TILE["kAmaxBlocks"]:
            raise ValueError(f"K1's pass A runs 1 to {TILE['kAmaxBlocks']} blocks, not {parts}")
        return "mls_quantize_rows", (M, K, width, variant, parts)
    if config is not None and config.variant != "cols":
        raise ValueError(f"K2 (grouping {grouping!r}) has one choice, 'cols', not {config}")
    width = k_block if grouping == "c" else K
    return "mls_quantize_cols", (M, K, width, int(K % 4 == 0 and width % 4 == 0))


def _amax_blocks(n: int, t: dict[str, int]) -> int:
    """Pass A's grid (and partial count) for an operand of ``n`` elements."""
    return max(1, min(t["kAmaxBlocks"], -(-n // t["kAmaxChunk"])))


def _amax_spec(n: int, t: dict[str, int], parts: int | None = None) -> LaunchSpec:
    """``quantize_amax`` on ``n`` elements: ``P`` blocks (``parts``,
    default :func:`_amax_blocks`) stride over x in ``kAmaxChunk``-element
    chunks (chunk ``s * P + b`` at stride step ``s``) and block ``b``
    writes partial max ``b``."""
    chunk = t["kAmaxChunk"]
    parts = _amax_blocks(n, t) if parts is None else parts
    chunks = -(-n // chunk)
    return LaunchSpec(
        kernel="quantize_amax", grid=(("block", parts), ("stride", -(-chunks // parts))),
        sequential=1,
        operands=(Operand("args[0]", "x", (n,), (chunk,), lambda b, s: (s * parts + b,),
                          masked=True),
                  Operand("outputs[0]", "partials", (parts,), (1,), lambda b, s: (b,),
                          output=True)),
        active=lambda b, s: s * parts + b < chunks)


def launch_spec_rows_amax(n: int, amax_blocks: int,
                          device_type: str = "cpu") -> tuple[LaunchSpec, LaunchSpec]:
    """K1's pass A alone on an operand of ``n`` elements
    (``mls_quantize_rows_amax``), two launches: ``quantize_amax``
    (:func:`_amax_spec`, ``amax_blocks`` partials), then one block of
    ``quantize_partials_max`` that reads them all and writes their max."""
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    amax = _amax_spec(n, t, amax_blocks)
    reduce = LaunchSpec(
        kernel="quantize_partials_max", grid=(("block", 1),), sequential=0,
        operands=(Operand("outputs[0]", "partials", (amax_blocks,), (amax_blocks,),
                          lambda b: (0,)),
                  Operand("outputs[1]", "amax", (1,), (1,), lambda b: (0,), output=True)))
    return amax, reduce


def launch_spec_rows_codes(M: int, K: int, group_width: int, variant: str, n_partials: int,
                           device_type: str = "cpu") -> LaunchSpec:
    """K1's pass B alone (``mls_quantize_rows_codes``) over ``n_partials``
    given partial maxima: the second launch of :func:`launch_spec_rows`."""
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    return _rows_codes_spec(M, K, group_width, variant, n_partials, t)


def launch_spec_rows(M: int, K: int, group_width: int, variant: str | None = None,
                     amax_blocks: int | None = None,
                     device_type: str = "cpu") -> tuple[LaunchSpec, LaunchSpec]:
    """The row-group kernel (K1) on an (M, K) operand in ``group_width``-wide
    groups (``mls_quantize_rows``), two launches:

    - pass A, ``quantize_amax`` (:func:`_amax_spec`): ``amax_blocks``
      (default: from the operand's size) partial maxima;
    - pass B: every block reads all ``P`` partials; then, ``variant``
      "warp" (default up to ``kWarpGroupMax``), a warp per group
      (``quantize_groups_warp``, warps striding over the groups: program
      ``(b, w, s)`` codes group ``(s * B + b) * 8 + w``), or "block"
      (default above), a block per group (``quantize_groups_block``).  A
      group codes row ``gid // ng``, group ``gid % ng`` and writes its
      group scale.

    Block 0 of pass B also stores the tensor scale, one scalar, which no
    tiled operand describes.
    """
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    amax = _amax_spec(M * K, t, amax_blocks)
    return amax, _rows_codes_spec(M, K, group_width, variant, amax.shape[0], t)


def _rows_codes_spec(M: int, K: int, group_width: int, variant: str | None, parts: int,
                     t: dict[str, int]) -> LaunchSpec:
    """K1's pass B over ``parts`` partial maxima (:func:`launch_spec_rows`)."""
    ng = K // group_width
    groups = M * ng
    if variant is None:
        variant = "warp" if group_width <= t["kWarpGroupMax"] else "block"
    if variant == "warp":
        warps = t["kThreads"] // 32
        blocks = min(t["kRowBlocks"], -(-groups // warps))
        kernel, sequential = "quantize_groups_warp", 1
        grid = (("block", blocks), ("warp", warps),
                ("stride", -(-groups // (blocks * warps))))

        def gid(b, w, s):
            return (s * blocks + b) * warps + w
    else:
        kernel, sequential, grid = "quantize_groups_block", 0, (("block", groups),)

        def gid(b):
            return b

    def group(*c):
        g = gid(*c)
        return g // ng, g % ng

    blk = (1, group_width)
    return LaunchSpec(
        kernel=kernel, grid=grid, sequential=sequential,
        operands=(Operand("args[0]", "x", (M, K), blk, group),
                  Operand("args[1]", "r_u8", (M, K), blk, group),
                  Operand("outputs[0]", "partials", (parts,), (parts,), lambda *c: (0,)),
                  Operand("outputs[2]", "codes", (M, K), blk, group, output=True),
                  Operand("outputs[3]", "s_g", (M, ng), (1, 1), group, output=True)),
        active=lambda *c: gid(*c) < groups)


@dataclasses.dataclass(frozen=True)
class ColTiling:
    """K2's column tiling (``col_tiling`` of ``csrc/mls_quantize.cu``): a
    thread owns ``v`` columns; a block is ``rb`` row lanes x ``s`` slots
    over column tile ``ct``; ``p`` row slices take the ``iters`` row
    iterations of ``rb`` rows in turn (slice ``p`` takes ``p``, ``p + P``,
    ...)."""

    v: int
    s: int
    rb: int
    ct: int
    p: int
    iters: int


def col_tiling(M: int, K: int, vec: int, target_blocks: int, threads: int) -> ColTiling:
    v = 4 if vec else 1
    slots = -(-K // v)
    s = 32
    while s < slots and s < threads:
        s *= 2
    rb, ct = threads // s, -(-slots // s)
    iters = -(-M // rb)
    return ColTiling(v, s, rb, ct, max(1, min(iters, -(-target_blocks // ct))), iters)


def _cols_partials(M: int, K: int, group_width: int, vec: int, t: dict[str, int]) -> int:
    """Floats of K2's pass-A scratch: P x K column maxima, or K1's
    pass-A partials for one group."""
    if K // group_width == 1:
        return _amax_blocks(M * K, t)
    return col_tiling(M, K, vec, t["kColAmaxBlocks"], t["kThreads"]).p * K


def _col_grid(ct: ColTiling):
    """The grid of a column pass, its active programs and the (row block,
    column tile) index of x's ``(rb, s * v)`` blocks."""
    grid = (("tile", ct.ct), ("slice", ct.p), ("iter", -(-ct.iters // ct.p)))
    return (grid, lambda c, p, i: i * ct.p + p < ct.iters,
            lambda c, p, i: (i * ct.p + p, c))


def _codes_spec(M: int, K: int, group_width: int, sg_stride: int, vec: int,
                t: dict[str, int], scales: str, codes: str) -> LaunchSpec:
    """``quantize_codes``: each block codes its ``(rb, s * v)`` blocks of
    x, one per row iteration, and reads the scales of the groups its
    columns lie in (the largest index is checked)."""
    ct = col_tiling(M, K, vec, t["kCodeBlocks"], t["kThreads"])
    grid, active, tile = _col_grid(ct)
    blk = (ct.rb, ct.s * ct.v)
    ng = K // group_width if sg_stride else 1

    def scale(c, p, i):
        last = np.minimum((c + 1) * blk[1], K) - 1
        return (0, (last // group_width) * sg_stride)

    return LaunchSpec(
        kernel="quantize_codes", grid=grid, sequential=1,
        operands=(Operand("args[0]", "x", (M, K), blk, tile, masked=True),
                  Operand("args[1]", "r_u8", (M, K), blk, tile, masked=True),
                  Operand(scales, "s_g", (1, ng), (1, 1), scale),
                  Operand(codes, "codes", (M, K), blk, tile, output=True, masked=True)),
        active=active)


def launch_spec_cols(M: int, K: int, group_width: int, vec: int,
                     device_type: str = "cpu") -> tuple[LaunchSpec, ...]:
    """K2 with its scales made on the card (``mls_quantize_cols``) on an
    (M, K) operand in G = K / ``group_width`` column groups:

    - G > 1 ("c"): pass A ``quantize_cols_amax`` (a (tile, slice, iter)
      grid; block (c, p) reads x's ``(rb, s * v)`` blocks of its row slice
      and writes its slice's column maxima, block (p, c) of the (P, K)
      scratch, revisited along the iterations it walks), then
      ``quantize_cols_reduce`` (a block per group reads the P x
      group_width partials of its group, writes its max);
    - G = 1 ("none"): K1's ``quantize_amax``;
    - ``quantize_scales``, one block: all maxima in, s_t and the G group
      scales out;
    - ``quantize_codes``: the code pass.
    """
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    G = K // group_width
    if G == 1:
        first = (_amax_spec(M * K, t),)
        vals = first[0].shape[0]
    else:
        ct = col_tiling(M, K, vec, t["kColAmaxBlocks"], t["kThreads"])
        grid, active, tile = _col_grid(ct)
        blk = (ct.rb, ct.s * ct.v)
        amax = LaunchSpec(
            kernel="quantize_cols_amax", grid=grid, sequential=1,
            operands=(Operand("args[0]", "x", (M, K), blk, tile, masked=True),
                      Operand("outputs[0]", "partials", (ct.p, K), (1, blk[1]),
                              lambda c, p, i: (p, c), output=True, masked=True)),
            active=active)
        reduce = LaunchSpec(
            kernel="quantize_cols_reduce", grid=(("group", G),), sequential=0,
            operands=(Operand("outputs[0]", "partials", (ct.p, K), (ct.p, group_width),
                              lambda g: (0, g)),
                      Operand("outputs[1]", "group_max", (G,), (1,), lambda g: (g,),
                              output=True)))
        first, vals = (amax, reduce), G
    scales = LaunchSpec(
        kernel="quantize_scales", grid=(("block", 1),), sequential=0,
        operands=(Operand("outputs[0]" if G == 1 else "outputs[1]", "maxima", (vals,),
                          (vals,), lambda b: (0,)),
                  Operand("outputs[4]", "s_g", (1, G), (1, G), lambda b: (0, 0),
                          output=True)))
    codes = _codes_spec(M, K, group_width, int(G > 1), vec, t, "outputs[4]", "outputs[3]")
    return (*first, scales, codes)


def launch_spec_given_sg(M: int, K: int, k_block: int, sg_stride: int, vec: int,
                         device_type: str = "cpu") -> LaunchSpec:
    """K2's code pass alone (``mls_quantize_given_sg``): the
    ``quantize_codes`` launch of :func:`launch_spec_cols` against given
    scales, ``(col // k_block) * sg_stride``."""
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    return _codes_spec(M, K, k_block, sg_stride, vec, t, "args[3]", "outputs[0]")
