"""Quantized-domain GEMM in the MLS format (paper Sec. V-B, Eq. 6-8).

:func:`mls_matmul` contracts packed codes group by group: an exact integer
dot per ``k_block``-wide scaling group, scaled by ``s_g^x ⊗ s_g^w`` and
accumulated in fp32 in k order, then multiplied once by the tensor scales.
On a CUDA tensor it launches ``csrc/mls_matmul.cu`` (the TPU's
``mls_matmul.py`` ``_kernel``); on a CPU tensor it runs the plain version,
:func:`repro_torch.kernels.ref.mls_matmul_ref`.  :func:`launch_spec`
describes its launches for the static verifier.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.intervals import Accumulation
from repro_torch.core.formats import EMFormat, accumulation_bits
from repro_torch.core.lowbit import GROUPINGS

from . import build, launch
from .launch import LaunchSpec, Operand
from .ref import mls_matmul_ref

__all__ = ["LAUNCHES", "TILE", "launch_spec", "mls_matmul", "sg_shapes"]

# Launches of the CUDA kernel, counted where the kernel is launched.
LAUNCHES = {"mls_matmul": 0}

# csrc/mls_matmul.cu's tile constants (mls_matmul_constants)
TILE = {"kBM": 64, "kBN": 64, "kKC": 32, "kThreads": 256}


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
) -> torch.Tensor:
    """Quantized-domain GEMM: codes x (M, K) @ codes w (K, N) -> f32 (M, N).

    Group scales arrive in the compact layout of ``grouping``
    (:func:`sg_shapes`); tensor scales are float32 scalars.  Code and scale
    tensors may be strided views (the weight typically arrives as the
    transpose of a K-contiguous (N, K) tensor).  Ragged M/N need no
    padding; ``K`` must be a multiple of ``k_block``.
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
    if x_codes.device.type == "cpu":
        launch.record("mls_matmul", "cpu", M, N, K, k_block, grouping, fmt)
        with launch.plain_version():
            return mls_matmul_ref(x_codes, x_sg, x_st.reshape(()), w_codes, w_sg,
                                  w_st.reshape(()), fmt, k_block)
    if x_codes.device.type != "cuda":
        raise ValueError(f"mls_matmul runs on cuda or cpu tensors, not {x_codes.device}")

    lib = build.library()
    x_st = x_st.contiguous()
    w_st = w_st.contiguous()
    out = torch.empty((M, N), dtype=torch.float32, device=x_codes.device)
    unit = 2.0 ** (2 * (fmt.e_min - fmt.m))
    build.check(lib.mls_matmul(
        x_codes.data_ptr(), *_strides(x_codes), x_sg.data_ptr(), *_strides(x_sg),
        w_codes.data_ptr(), *_strides(w_codes), w_sg.data_ptr(), *_strides(w_sg),
        x_st.data_ptr(), w_st.data_ptr(), unit, out.data_ptr(), M, N, K, k_block,
        fmt.e, fmt.m, torch.cuda.current_stream(x_codes.device).cuda_stream),
        "mls_matmul")
    LAUNCHES["mls_matmul"] += 1
    launch.record("mls_matmul", "cuda", M, N, K, k_block, grouping, fmt)
    return out


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
                device_type: str = "cpu") -> LaunchSpec:
    """K3 on codes x (M, K) @ w (K, N): one block per ``kBM x kBN`` output
    tile, walking the ``K / k_block`` scaling groups in order; each group is
    an exact int32 dot of ``k_block`` products of decoded fractions."""
    t = launch.tile_constants("mls_matmul_constants", TILE, device_type)
    bm, bn = t["kBM"], t["kBN"]
    xs, ws = sg_shapes(grouping, M, N, K // k_block)
    return LaunchSpec(
        kernel="mls_matmul",
        grid=(("tile_m", -(-M // bm)), ("tile_n", -(-N // bn)), ("group", K // k_block)),
        sequential=1,
        operands=(Operand("args[0]", "x_codes", (M, K), (bm, k_block),
                          lambda i, j, g: (i, g), masked=True),
                  _sg_operand("args[1]", grouping, xs, True, bm),
                  Operand("args[2]", "w_codes", (K, N), (k_block, bn),
                          lambda i, j, g: (g, j), masked=True),
                  _sg_operand("args[3]", grouping, ws, False, bn),
                  Operand("outputs[0]", "out", (M, N), (bm, bn), lambda i, j, g: (i, j),
                          output=True, masked=True)),
        accumulations=(Accumulation("dot", k_block, fmt.max_fraction),),
        macs=M * N * K)
