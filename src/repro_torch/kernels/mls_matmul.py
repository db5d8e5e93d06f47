"""Quantized-domain GEMM in the MLS format (paper Sec. V-B, Eq. 6-8).

:func:`mls_matmul` contracts packed codes group by group: an exact integer
dot per ``k_block``-wide scaling group, scaled by ``s_g^x ⊗ s_g^w`` and
accumulated in fp32 in k order, then multiplied once by the tensor scales.
On a CUDA tensor it launches ``csrc/mls_matmul.cu`` (the TPU's
``mls_matmul.py`` ``_kernel``) as :func:`matmul_plan` says: a walk over the
groups inside each output tile, or an ordered split (every group's term in
parallel, then a pass that adds them in k order), on int8 tensor cores or,
for formats whose fractions exceed int8, an int32 body.  On a CPU tensor it
runs the plain version, :func:`repro_torch.kernels.ref.mls_matmul_ref`.
:func:`launch_spec` describes its launches for the static verifier.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.intervals import Accumulation
from repro_torch.core.formats import EMFormat, accumulation_bits
from repro_torch.core.lowbit import GROUPINGS

from . import build, launch
from .launch import LaunchSpec, Operand
from .ref import mls_matmul_ref

__all__ = ["LAUNCHES", "SMS", "TILE", "MatmulPlan", "launch_spec", "matmul_plan", "mls_matmul",
           "sg_shapes"]

# Launches of the C entry point (one per call, whatever its plan runs),
# counted where it is called.
LAUNCHES = {"mls_matmul": 0}

# csrc/mls_matmul.cu's tile constants (mls_matmul_constants)
TILE = {"kBM": 64, "kKStep": 16, "kThreads": 128, "kSumThreads": 64}

SMS = 132  # streaming multiprocessors of an H100 SXM
WORKSPACE_LIMIT = 256 << 20  # bytes of split terms a call may allocate
_MAX_GRID_YZ = 65535


@dataclasses.dataclass(frozen=True)
class MatmulPlan:
    """How K3 runs one GEMM.

    ``variant``: ``"walk"`` (a block per output tile walks the groups in
    order) or ``"split"`` (every (tile, group) term in parallel into a
    ``(G, M, N)`` fp32 workspace, then an ordered sum).  ``body``:
    ``"int8"`` (s8 tensor-core MMA) or ``"int32"`` (CUDA cores, for formats
    whose fractions exceed 127).  ``bn``: the tile's N extent.
    """

    variant: str
    body: str
    bn: int
    workspace_bytes: int


def matmul_plan(M: int, N: int, K: int, k_block: int, fmt: EMFormat) -> MatmulPlan:
    """K3's plan for an (M, K) @ (K, N) GEMM in ``k_block``-wide groups.

    The tile is ``kBM`` = 64 rows by ``bn`` = 16, 32 or 64 columns, the
    narrowest that holds N.  With G = K / k_block groups, the split runs
    when the walk would leave SMs idle (fewer output tiles than the 132
    SMs), there is more than one group, and its workspace of G * M * N
    fp32 terms stays within ``WORKSPACE_LIMIT``.  The body is int8 when
    ``fmt.max_fraction <= 127``, else int32.
    """
    if k_block < 1 or K % k_block:
        raise ValueError(f"K={K} is not a multiple of k_block={k_block}")
    bn = 16 if N <= 16 else 32 if N <= 32 else 64
    groups = K // k_block
    tiles = -(-M // TILE["kBM"]) * -(-N // bn)
    workspace = groups * M * N * 4
    split = (groups > 1 and tiles < SMS and workspace <= WORKSPACE_LIMIT
             and groups <= _MAX_GRID_YZ)
    return MatmulPlan("split" if split else "walk",
                      "int8" if fmt.max_fraction <= 127 else "int32", bn,
                      workspace if split else 0)


def sg_shapes(
    grouping: str, M: int, N: int, n_kb: int
) -> tuple[tuple[int, int], tuple[int, int]]:
    """Compact group-scale layouts ``(x_sg, w_sg)`` for an (M, K, N) GEMM.

    ``"nc"``: x (M, K/kb), w (K/kb, N); ``"c"``: (1, K/kb) / (K/kb, 1);
    ``"n"``: (M, 1) / (1, N); ``"none"``: (1, 1) / (1, 1).
    """
    if grouping == "nc":
        return (M, n_kb), (n_kb, N)
    if grouping == "c":
        return (1, n_kb), (n_kb, 1)
    if grouping == "n":
        return (M, 1), (1, N)
    if grouping == "none":
        return (1, 1), (1, 1)
    raise ValueError(f"unknown grouping {grouping!r}; expected {GROUPINGS}")


def _strides(t: torch.Tensor) -> tuple[int, int]:
    """Element strides of a 2-D tensor, 0 along a size-1 (broadcast) axis."""
    return tuple(0 if d == 1 else s for d, s in zip(t.shape, t.stride()))


def mls_matmul(
    x_codes: torch.Tensor,
    x_sg: torch.Tensor,
    x_st: torch.Tensor,
    w_codes: torch.Tensor,
    w_sg: torch.Tensor,
    w_st: torch.Tensor,
    fmt: EMFormat,
    k_block: int = 128,
    grouping: str = "nc",
    plan: MatmulPlan | None = None,
) -> torch.Tensor:
    """Quantized-domain GEMM: codes x (M, K) @ codes w (K, N) -> f32 (M, N).

    Group scales arrive in the compact layout of ``grouping``
    (:func:`sg_shapes`); tensor scales are float32 scalars.  Code and scale
    tensors may be strided views (the weight typically arrives as the
    transpose of a K-contiguous (N, K) tensor).  Ragged M/N need no
    padding; ``K`` must be a multiple of ``k_block``.  ``plan`` (default:
    :func:`matmul_plan`) picks the kernel's variant, body and tile; every
    plan gives the same bits.
    """
    if x_codes.ndim != 2 or w_codes.ndim != 2:
        raise ValueError("mls_matmul takes 2-D code tensors")
    M, K = x_codes.shape
    K2, N = w_codes.shape
    if K != K2:
        raise ValueError(f"contraction mismatch {tuple(x_codes.shape)} @ {tuple(w_codes.shape)}")
    if K % k_block:
        raise ValueError(f"mls_matmul: K={K} is not a multiple of k_block={k_block} "
                         f"(group boundaries would not align)")
    if accumulation_bits(fmt, k_block) >= 24:
        raise ValueError(f"k_block={k_block} products of {fmt} values overflow the "
                         f"exact fp32 range of a group sum")
    exp_x, exp_w = sg_shapes(grouping, M, N, K // k_block)
    if tuple(x_sg.shape) != exp_x or tuple(w_sg.shape) != exp_w:
        raise ValueError(f"group-scale layout mismatch for grouping={grouping!r}: expected "
                         f"x_sg {exp_x} / w_sg {exp_w}, got {tuple(x_sg.shape)} / "
                         f"{tuple(w_sg.shape)}")
    tensors = (x_codes, x_sg, x_st, w_codes, w_sg, w_st)
    if x_codes.dtype != torch.uint8 or w_codes.dtype != torch.uint8:
        raise ValueError("codes must be uint8")
    if any(t.dtype != torch.float32 for t in (x_sg, x_st, w_sg, w_st)):
        raise ValueError("scales must be float32")
    if x_st.numel() != 1 or w_st.numel() != 1:
        raise ValueError("tensor scales must be scalars")
    if any(t.device != x_codes.device for t in tensors):
        raise ValueError("mls_matmul operands must share one device")
    plan = _checked_plan(plan, M, N, K, k_block, fmt)
    if x_codes.device.type == "cpu":
        launch.record("mls_matmul", "cpu", M, N, K, k_block, grouping, fmt, plan)
        with launch.plain_version():
            return mls_matmul_ref(x_codes, x_sg, x_st.reshape(()), w_codes, w_sg,
                                  w_st.reshape(()), fmt, k_block)
    if x_codes.device.type != "cuda":
        raise ValueError(f"mls_matmul runs on cuda or cpu tensors, not {x_codes.device}")

    lib = build.library()
    x_st = x_st.contiguous()
    w_st = w_st.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x_codes.device)
    split = plan.variant == "split"
    terms = (torch.empty((K // k_block, M, N), dtype=torch.float32, device=x_codes.device)
             if split else None)
    unit = 2.0 ** (2 * (fmt.e_min - fmt.m))
    build.check(lib.mls_matmul(
        x_codes.data_ptr(), *_strides(x_codes), x_sg.data_ptr(), *_strides(x_sg),
        w_codes.data_ptr(), *_strides(w_codes), w_sg.data_ptr(), *_strides(w_sg),
        x_st.data_ptr(), w_st.data_ptr(), unit, out.data_ptr(),
        terms.data_ptr() if split else None, M, N, K, k_block, fmt.e, fmt.m, plan.bn,
        _BODIES.index(plan.body), int(split),
        torch.cuda.current_stream(x_codes.device).cuda_stream), "mls_matmul")
    LAUNCHES["mls_matmul"] += 1
    launch.record("mls_matmul", "cuda", M, N, K, k_block, grouping, fmt, plan)
    return out


_BODIES = ("int8", "int32")  # the C entry point's body codes


def _checked_plan(plan: MatmulPlan | None, M: int, N: int, K: int, k_block: int,
                  fmt: EMFormat) -> MatmulPlan:
    """``plan``, or :func:`matmul_plan`'s; raise on one the kernel cannot
    run exactly."""
    if plan is None:
        return matmul_plan(M, N, K, k_block, fmt)
    if plan.variant not in ("walk", "split") or plan.body not in _BODIES or \
            plan.bn not in (16, 32, 64):
        raise ValueError(f"unknown K3 plan {plan}")
    if plan.body == "int8" and fmt.max_fraction > 127:
        raise ValueError(f"{fmt} fractions reach {fmt.max_fraction}: beyond int8, the int8 "
                         f"body would be wrong")
    groups = K // k_block
    if plan.variant == "split":
        if not 1 <= groups <= _MAX_GRID_YZ:
            raise ValueError(f"the split runs one grid slice per group: {groups} groups")
        return dataclasses.replace(plan, workspace_bytes=groups * M * N * 4)
    return dataclasses.replace(plan, workspace_bytes=0)


def _sg_operand(name: str, grouping: str, shape: tuple[int, int], x_side: bool,
                tile: int) -> Operand:
    """A compact group-scale operand: the x side is read at (row tile, group),
    the weight side at (group, column tile), in the grouping's layout
    (:func:`sg_shapes`); a size-1 axis is broadcast."""
    rows, cols = shape
    if x_side:
        blk = (tile if rows > 1 else 1, 1)

        def index(i, j, g):
            return (i if rows > 1 else 0, g if cols > 1 else 0)
    else:
        blk = (1, tile if cols > 1 else 1)

        def index(i, j, g):
            return (g if rows > 1 else 0, j if cols > 1 else 0)
    return Operand(name, "x_sg" if x_side else "w_sg", shape, blk, index, masked=True)


def launch_spec(M: int, N: int, K: int, k_block: int, grouping: str, fmt: EMFormat,
                plan: MatmulPlan | None = None,
                device_type: str = "cpu") -> tuple[LaunchSpec, ...]:
    """K3's device launches for codes x (M, K) @ w (K, N) under ``plan``
    (default :func:`matmul_plan`).  Each group is an exact integer dot of
    ``k_block`` products of decoded fractions.

    - walk: ``mls_matmul_walk``, a block per ``kBM x bn`` output tile,
      walking the ``K / k_block`` groups in order (a sequential axis).
    - split: ``mls_matmul_terms``, a fully parallel grid (row tile, column
      tile, group) writing block (g, i, j) of the workspace T (G, M, N);
      then ``mls_matmul_sum``, a block per ``kSumThreads`` output elements
      (row-major) walking the groups of T in order.

    The launch that computes the dots carries the call's ``M * N * K``
    quantized MACs; the ordered sum carries none.
    """
    plan = _checked_plan(plan, M, N, K, k_block, fmt)
    t = launch.tile_constants("mls_matmul_constants", TILE, device_type)
    bm, bn, groups = t["kBM"], plan.bn, K // k_block
    xs, ws = sg_shapes(grouping, M, N, groups)
    split = plan.variant == "split"
    dots = LaunchSpec(
        kernel="mls_matmul_terms" if split else "mls_matmul_walk",
        grid=(("tile_m", -(-M // bm)), ("tile_n", -(-N // bn)), ("group", groups)),
        sequential=0 if split else 1,
        operands=(Operand("args[0]", "x_codes", (M, K), (bm, k_block),
                          lambda i, j, g: (i, g), masked=True),
                  _sg_operand("args[1]", grouping, xs, True, bm),
                  Operand("args[2]", "w_codes", (K, N), (k_block, bn),
                          lambda i, j, g: (g, j), masked=True),
                  _sg_operand("args[3]", grouping, ws, False, bn),
                  Operand("outputs[1]", "terms", (groups, M, N), (1, bm, bn),
                          lambda i, j, g: (g, i, j), output=True, masked=True)
                  if split else
                  Operand("outputs[0]", "out", (M, N), (bm, bn), lambda i, j, g: (i, j),
                          output=True, masked=True)),
        accumulations=(Accumulation("dot", k_block, fmt.max_fraction),),
        macs=M * N * K)
    if not split:
        return (dots,)
    threads, mn = t["kSumThreads"], M * N
    ordered_sum = LaunchSpec(
        kernel="mls_matmul_sum",
        grid=(("block", -(-mn // threads)), ("group", groups)),
        sequential=1,
        operands=(Operand("outputs[1]", "terms", (groups, mn), (1, threads),
                          lambda b, g: (g, b), masked=True),
                  Operand("outputs[0]", "out", (mn,), (threads,), lambda b, g: (b,),
                          output=True, masked=True)))
    return dots, ordered_sum
