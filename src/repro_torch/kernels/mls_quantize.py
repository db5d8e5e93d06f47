"""MLS dynamic quantization of a 2-D GEMM operand (paper Alg. 2).

:func:`mls_quantize` returns packed ``sign|exp|man`` uint8 codes, the group
scales in the compact layout of the grouping (paper Table IV) and the
tensor scale.  On a CUDA tensor it launches the kernels of
``csrc/mls_quantize.cu``: the row-group kernel (groupings "nc", "n"; the
TPU's ``_kernel_rowwise``), two passes in one call that also take the
tensor scale, or the given-scale kernel ("c", "none"; the TPU's
``_kernel_given_sg``).  On a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.quantize_ref`.  :func:`quantize_given_scales`
is the given-scale kernel's own wrapper, for callers that bring their
scales (the implicit conv's code reuse).  :func:`launch_spec_rows` and
:func:`launch_spec_given_sg` describe the two kernels' launches for the
static verifier.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.formats import EMFormat, GS_FMT_DEFAULT
from repro_torch.core.lowbit import GROUPINGS
from repro_torch.core.quantize import quantize_group_scale

from . import build, launch
from .launch import LaunchSpec, Operand
from .ref import element_codes_ref, quantize_ref

__all__ = [
    "LAUNCHES",
    "TILE",
    "launch_spec_given_sg",
    "launch_spec_rows",
    "mls_quantize",
    "quantize_launch",
    "quantize_given_scales",
    "rounding_bytes",
]

# Launches of each CUDA kernel, counted where the kernel is launched.
LAUNCHES = {"mls_quantize_rows": 0, "mls_quantize_given_sg": 0}

# csrc/mls_quantize.cu's launch constants (mls_quantize_constants)
TILE = {"kThreads": 256, "kWarpGroupMax": 1024, "kGivenMaxBlocks": 132 * 32,
        "kAmaxBlocks": 2 * 132, "kAmaxChunk": 256 * 16, "kRowBlocks": 8 * 132}

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
        kernel, args = quantize_launch(M, K, k_block, grouping)  # what the card would run
        launch.record(kernel, "cpu", *args)
        with launch.plain_version():
            return quantize_ref(x, fmt, k_block, gs_fmt, r_u8, grouping)
    if x.device.type != "cuda":
        raise ValueError(f"mls_quantize runs on cuda or cpu tensors, not {x.device}")

    if x.numel() == 0:
        raise ValueError("mls_quantize takes a non-empty operand (its tensor scale is a max)")
    if grouping in ("nc", "n"):
        width = k_block if grouping == "nc" else K
        dev = x.device
        partials = torch.empty((_amax_blocks(M * K, TILE),), dtype=torch.float32, device=dev)
        s_t = torch.empty((), dtype=torch.float32, device=dev)
        codes = torch.empty((M, K), dtype=torch.uint8, device=dev)
        s_g = torch.empty((M, K // width), dtype=torch.float32, device=dev)
        build.check(build.library().mls_quantize_rows(
            x.data_ptr(), r_u8.data_ptr(), partials.data_ptr(), partials.numel(),
            s_t.data_ptr(), codes.data_ptr(), s_g.data_ptr(), M, K, width,
            *_fmt_args(fmt, gs_fmt), torch.cuda.current_stream(dev).cuda_stream),
            "mls_quantize_rows")
        LAUNCHES["mls_quantize_rows"] += 1
        launch.record("mls_quantize_rows", "cuda", M, K, width)
        return codes, s_g, s_t
    s_t = torch.amax(x.abs())
    s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
    # "c" / "none": compact scales computed ahead (the "c" group max crosses
    # all rows), with the same exact group-scale math
    if grouping == "c":
        s_r = x.abs().amax(dim=0).reshape(K // k_block, k_block).amax(dim=1)
        s_g = quantize_group_scale(s_r / s_t, gs_fmt)[0].reshape(1, -1).contiguous()
    else:
        s_g = torch.ones((1, 1), dtype=torch.float32, device=x.device)
    return quantize_given_scales(x, fmt, s_t, s_g, k_block, r_u8), s_g, s_t


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
    if x.device.type == "cpu":
        launch.record("mls_quantize_given_sg", "cpu", M, K, k_block, sg_stride)
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
    build.check(build.library().mls_quantize_given_sg(
        x.data_ptr(), r_u8.data_ptr(), s_t.data_ptr(), s_g.data_ptr(),
        codes.data_ptr(), M, K, k_block, sg_stride,
        *_fmt_args(fmt, GS_FMT_DEFAULT), torch.cuda.current_stream(x.device).cuda_stream),
        "mls_quantize_given_sg")
    LAUNCHES["mls_quantize_given_sg"] += 1
    launch.record("mls_quantize_given_sg", "cuda", M, K, k_block, sg_stride)
    return codes


# ---------------------------------------------------------------------------
# Launch descriptors
# ---------------------------------------------------------------------------
def quantize_launch(M: int, K: int, k_block: int, grouping: str) -> tuple[str, tuple]:
    """The kernel :func:`mls_quantize` launches on an (M, K) operand and its
    launch arguments (those of :func:`launch_spec_rows` /
    :func:`launch_spec_given_sg`)."""
    if grouping in ("nc", "n"):
        return "mls_quantize_rows", (M, K, k_block if grouping == "nc" else K)
    return "mls_quantize_given_sg", (M, K, k_block, int(grouping == "c" and K > k_block))


def _amax_blocks(n: int, t: dict[str, int]) -> int:
    """Pass A's grid (and partial count) for an operand of ``n`` elements."""
    return max(1, min(t["kAmaxBlocks"], -(-n // t["kAmaxChunk"])))


def launch_spec_rows(M: int, K: int, group_width: int,
                     device_type: str = "cpu") -> tuple[LaunchSpec, LaunchSpec]:
    """The row-group kernel (K1) on an (M, K) operand in ``group_width``-wide
    groups (``mls_quantize_rows``), two launches:

    - pass A, ``quantize_amax``: ``P`` blocks stride over x in
      ``kAmaxChunk``-element chunks (chunk ``s * P + b`` at stride step
      ``s``) and block ``b`` writes partial max ``b``;
    - pass B: every block reads all ``P`` partials; then a warp per group up
      to ``kWarpGroupMax`` (``quantize_groups_warp``, warps striding over
      the groups: program ``(b, w, s)`` codes group ``(s * B + b) * 8 + w``),
      else a block per group (``quantize_groups_block``).  A group codes
      row ``gid // ng``, group ``gid % ng`` and writes its group scale.

    Block 0 of pass B also stores the tensor scale, one scalar, which no
    tiled operand describes.
    """
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    n, chunk = M * K, t["kAmaxChunk"]
    parts = _amax_blocks(n, t)
    chunks = -(-n // chunk)
    amax = LaunchSpec(
        kernel="quantize_amax", grid=(("block", parts), ("stride", -(-chunks // parts))),
        sequential=1,
        operands=(Operand("args[0]", "x", (n,), (chunk,), lambda b, s: (s * parts + b,),
                          masked=True),
                  Operand("outputs[0]", "partials", (parts,), (1,), lambda b, s: (b,),
                          output=True)),
        active=lambda b, s: s * parts + b < chunks)

    ng = K // group_width
    groups = M * ng
    if group_width <= t["kWarpGroupMax"]:
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
    codes = LaunchSpec(
        kernel=kernel, grid=grid, sequential=sequential,
        operands=(Operand("args[0]", "x", (M, K), blk, group),
                  Operand("args[1]", "r_u8", (M, K), blk, group),
                  Operand("outputs[0]", "partials", (parts,), (parts,), lambda *c: (0,)),
                  Operand("outputs[2]", "codes", (M, K), blk, group, output=True),
                  Operand("outputs[3]", "s_g", (M, ng), (1, 1), group, output=True)),
        active=lambda *c: gid(*c) < groups)
    return amax, codes


def launch_spec_given_sg(M: int, K: int, k_block: int, sg_stride: int,
                         device_type: str = "cpu") -> LaunchSpec:
    """The given-scale kernel (K2): a grid-stride pass over the M*K elements
    in row-major order.  Block ``b`` at stride step ``s`` codes the
    ``kThreads`` elements of chunk ``s * blocks + b``; each element reads
    its compact group scale ``(col // k_block) * sg_stride``."""
    t = launch.tile_constants("mls_quantize_constants", TILE, device_type)
    n, threads = M * K, t["kThreads"]
    chunks = -(-n // threads)
    blocks = min(chunks, t["kGivenMaxBlocks"])
    strides = -(-chunks // blocks) if blocks else 0

    def chunk(b, s):
        return (s * blocks + b,)

    def scale(b, s):  # the largest scale index a chunk reads
        first = (s * blocks + b) * threads
        last = np.minimum(first + threads, n) - 1
        col = np.where(last // K > first // K, K - 1, last % K)
        return (0, (col // k_block) * sg_stride)

    blk = (threads,)
    return LaunchSpec(
        kernel="mls_quantize_given_sg", grid=(("block", blocks), ("stride", strides)),
        sequential=1,
        operands=(Operand("args[0]", "x", (n,), blk, chunk, masked=True),
                  Operand("args[1]", "r_u8", (n,), blk, chunk, masked=True),
                  Operand("args[3]", "s_g", (1, K // k_block if sg_stride else 1), (1, 1),
                          scale),
                  Operand("outputs[0]", "codes", (n,), blk, chunk, output=True, masked=True)),
        active=lambda b, s: s * blocks + b < chunks)
