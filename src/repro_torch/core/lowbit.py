"""Low-bit training configuration (paper Alg. 1 / Sec. V-B).

:class:`QuantConfig` says how a layer quantizes the three operands of its
conv/matmul (weights, activations, back-propagated errors).  Stochastic
rounding (paper Eq. 5) draws its uint8 rounding bytes from a seeded
``torch.Generator`` per (step, site tag, GEMM index): :func:`fold_in`
derives the seeds, :func:`rounding_generator` builds the generator.
"""
from __future__ import annotations

import dataclasses

import torch

from .formats import EMFormat, FMT_IMAGENET, GS_FMT_DEFAULT, accumulation_bits

__all__ = ["GROUPINGS", "QuantConfig", "fold_in", "rounding_generator"]

GROUPINGS = ("nc", "c", "n", "none")  # scaling-group layouts, paper Table IV


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How a layer quantizes its three conv/matmul operands."""

    fmt: EMFormat = FMT_IMAGENET  # <Ex,Mx> for W/A/E (paper uses one format)
    gs_fmt: EMFormat = GS_FMT_DEFAULT  # <Eg,Mg> group-scale format
    grouping: str = "nc"  # "nc" | "c" | "n" | "none"  (paper Table IV)
    k_block: int = 128  # contraction block of a scaling group
    stochastic: bool = True  # stochastic rounding (False -> nearest)
    enabled: bool = True
    # Arithmetic of the three training GEMMs: "quantized" runs them in the
    # MLS quantized domain (mls_quantize -> mls_matmul over im2col).
    # "fake_quant" (quantize-dequantize + float conv) is not ported yet.
    backend: str = "quantized"
    # Forward-conv lowering: "im2col", "implicit" (the implicit-GEMM kernel;
    # needs k_block = cb*kh*kw with cb | C) or "auto" (implicit where legal,
    # else im2col).  The choice never changes numerics.
    conv_impl: str = "auto"

    def __post_init__(self):
        if self.backend == "fake_quant":
            raise NotImplementedError(
                "QuantConfig.backend='fake_quant' is not ported yet "
                "(ROADMAP.md queue 1, item 1: lowbit_matmul/lowbit_conv)"
            )
        if self.backend != "quantized":
            raise ValueError(
                f"QuantConfig.backend must be 'quantized', got {self.backend!r}"
            )
        if self.grouping not in GROUPINGS:
            raise ValueError(
                f"QuantConfig.grouping must be one of 'nc'/'c'/'n'/'none', "
                f"got {self.grouping!r}"
            )
        if self.conv_impl not in ("auto", "im2col", "implicit"):
            raise ValueError(
                f"QuantConfig.conv_impl must be 'auto', 'im2col' or 'implicit', "
                f"got {self.conv_impl!r}"
            )
        # A scaling group sums k_block products of product_bits-wide
        # integers; the sum must stay exact (below 2^24) in fp32.
        acc = accumulation_bits(self.fmt, self.k_block)
        if acc >= 24:
            raise ValueError(
                f"QuantConfig: accumulating k_block={self.k_block} products "
                f"of {self.fmt} values spans {acc} integer bits "
                f"(product_bits={self.fmt.product_bits} + "
                f"ceil(log2(k_block))) >= 24, so fp32 accumulation is no "
                f"longer exact integer arithmetic. Reduce k_block or use a "
                f"narrower <E,M> format."
            )


_MASK64 = (1 << 64) - 1


def fold_in(key: int | None, data: int) -> int | None:
    """Derive an independent 63-bit stream seed from ``key`` and ``data``
    (splitmix64 of the pair); ``None`` stays ``None`` (no randomness)."""
    if key is None:
        return None
    z = (key * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def rounding_generator(
    key: int | None, cfg: QuantConfig, idx: int, device: torch.device | str
) -> torch.Generator | None:
    """The rounding stream of GEMM operand ``idx`` (0-5) at one site: a
    generator on ``device`` seeded from ``fold_in(key, idx)``, or ``None``
    when rounding is deterministic."""
    if key is None or not cfg.stochastic:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(fold_in(key, idx))
    return g
