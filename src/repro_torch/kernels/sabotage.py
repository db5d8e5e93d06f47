"""The static verifier's planted-overlap control (K5).

:func:`sabotage_overlap_matmul` is a deliberately wrong fp32 tiled matmul,
the TPU's ``analysis/kernel_verify.py`` ``_sabotage_overlap_jaxpr`` kernel
ported to CUDA (``csrc/sabotage_overlap.cu``): program (i, j) computes the
8x8 tile (i, j) of ``x @ w`` and stores it at block (i, j - j % 2), so block
columns 0 and 2 are written twice and 1 and 3 never.  The audit runs it
under ``--sabotage overlap_write`` and the verifier must report the overlap
and the gap from its :func:`launch_spec`.  It never runs on the training
path.  On a CPU tensor the wrapper runs the plain version,
:func:`repro_torch.kernels.ref.sabotage_overlap_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.intervals import Accumulation

from . import build, launch
from .launch import LaunchSpec, Operand
from .ref import sabotage_overlap_ref

__all__ = ["LAUNCHES", "TILE", "launch_spec", "sabotage_overlap_matmul"]

# Launches of the CUDA kernel, counted where the kernel is launched.
LAUNCHES = {"sabotage_overlap": 0}

# csrc/sabotage_overlap.cu's tile constants (sabotage_overlap_constants)
TILE = {"kBM": 8, "kBN": 8, "kBK": 8, "kThreads": 64}


def sabotage_overlap_matmul(x: torch.Tensor, w: torch.Tensor,
                            probe: torch.Tensor | None = None) -> torch.Tensor:
    """K5 on contiguous float32 ``x`` (M, K) and ``w`` (K, N), every extent a
    multiple of 8 and N of 16 (the TPU's shapes: (8, 16) @ (16, 32)).

    The output starts as NaN, as in Pallas interpret mode, so the blocks no
    program writes stay NaN.  ``probe``, an int32 (M, N) tensor, gains one
    per store to each element: on the card the two writers of a block race,
    and the probe shows that both stored.
    """
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"sabotage_overlap_matmul takes x (M, K) @ w (K, N), got "
                         f"{tuple(x.shape)} @ {tuple(w.shape)}")
    M, K = x.shape
    N = w.shape[1]
    if M % 8 or K % 8 or N % 16:
        raise ValueError(f"M={M} and K={K} must be multiples of 8 and N={N} of 16")
    if any(t.dtype != torch.float32 or not t.is_contiguous() for t in (x, w)):
        raise ValueError("x and w must be contiguous float32 tensors")
    if w.device != x.device:
        raise ValueError("x and w must share one device")
    if probe is not None and (tuple(probe.shape) != (M, N) or probe.dtype != torch.int32
                              or probe.device != x.device or not probe.is_contiguous()):
        raise ValueError(f"probe must be a contiguous int32 ({M}, {N}) tensor on {x.device}")
    if x.device.type == "cpu":
        launch.record("sabotage_overlap", "cpu", M, K, N)
        with launch.plain_version():
            out, writes = sabotage_overlap_ref(x, w)
        if probe is not None:
            probe += writes
        return out
    if x.device.type != "cuda":
        raise ValueError(f"sabotage_overlap_matmul runs on cuda or cpu tensors, not {x.device}")
    out = torch.full((M, N), float("nan"), dtype=torch.float32, device=x.device)
    build.check(build.library().sabotage_overlap(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        None if probe is None else probe.data_ptr(), M, K, N,
        torch.cuda.current_stream(x.device).cuda_stream), "sabotage_overlap")
    LAUNCHES["sabotage_overlap"] += 1
    launch.record("sabotage_overlap", "cuda", M, K, N)
    return out


def launch_spec(M: int, K: int, N: int, device_type: str = "cpu") -> LaunchSpec:
    """K5's launch: CUDA grid (M/8, N/8), each block walking the K/8 k-tiles
    in order; output block (i, j - j % 2), the planted fault."""
    t = launch.tile_constants("sabotage_overlap_constants", TILE, device_type)
    bm, bn, bk = t["kBM"], t["kBN"], t["kBK"]
    return LaunchSpec(
        kernel="sabotage_overlap",
        grid=(("tile_m", M // bm), ("tile_n", N // bn), ("k", K // bk)), sequential=1,
        operands=(Operand("args[0]", "x", (M, K), (bm, bk), lambda i, j, k: (i, k)),
                  Operand("args[1]", "w", (K, N), (bk, bn), lambda i, j, k: (k, j)),
                  Operand("outputs[0]", "out", (M, N), (bm, bn),
                          lambda i, j, k: (i, j - j % 2), output=True)),
        accumulations=(Accumulation("dot", K, float("inf"), integer=False),))
