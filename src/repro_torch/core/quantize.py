"""Dynamic quantization to the MLS tensor format (paper Alg. 2): grouping,
the ceil-rounded group-scale quantizer and the element quantizer.

Grouping is expressed by a :class:`GroupSpec`: a per-axis block size.  Block
size 1 makes the axis a pure group axis (one group per index), block size ==
axis length reduces the whole axis into the group.  A matmul operand
``(M, K)`` grouped per row and per 128-wide contraction block is
``GroupSpec((1, 128))``.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from .formats import EMFormat, exponent_fraction, pow2

__all__ = [
    "GroupSpec",
    "broadcast_groups",
    "group_reduce_max",
    "quantize_elements",
    "quantize_group_scale",
]


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Per-axis block sizes defining scaling groups.

    ``block[i]`` elements along axis ``i`` share one group (together with the
    blocks of every other axis).  ``None`` means "whole axis in one group".
    """

    block: tuple[int | None, ...]

    def resolve(self, shape: Sequence[int]) -> tuple[int, ...]:
        if len(self.block) != len(shape):
            raise ValueError(f"GroupSpec rank {len(self.block)} != tensor rank {len(shape)}")
        out = []
        for b, d in zip(self.block, shape):
            b = d if b is None else min(b, d)
            if d % b != 0:
                b = d  # one group over the whole axis (coarser, still correct)
            out.append(b)
        return tuple(out)

    def group_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(d // b for d, b in zip(shape, self.resolve(shape)))

    @staticmethod
    def per_tensor(rank: int) -> GroupSpec:
        return GroupSpec((None,) * rank)


def _split_axes(x: torch.Tensor, blocks: tuple[int, ...]) -> torch.Tensor:
    """Reshape (d0, d1, ...) -> (g0, b0, g1, b1, ...)."""
    new_shape = []
    for d, b in zip(x.shape, blocks):
        new_shape.extend((d // b, b))
    return x.reshape(new_shape)


def group_reduce_max(x: torch.Tensor, spec: GroupSpec) -> torch.Tensor:
    blocks = spec.resolve(x.shape)
    xs = _split_axes(x, blocks)
    return torch.amax(xs, dim=tuple(range(1, xs.ndim, 2)))


def broadcast_groups(s: torch.Tensor, spec: GroupSpec, shape: Sequence[int]) -> torch.Tensor:
    """Broadcast a group-shaped array back to the full tensor shape."""
    blocks = spec.resolve(shape)
    expanded = s.reshape(tuple(v for g in s.shape for v in (g, 1)))
    tiled = expanded.expand(tuple(v for g, b in zip(s.shape, blocks) for v in (g, b)))
    return tiled.reshape(tuple(shape))


def quantize_group_scale(
    s_gf: torch.Tensor, gs_fmt: EMFormat
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize group/tensor scale ratios in [0, 1] (paper Alg. 2 l.4-8).

    Fractions are *ceil*-rounded so the quantized scale is >= the true
    ratio, keeping normalized elements <= 1.  Returns ``(s_g, exp_g,
    man_g)`` with ``s_g = (1 + man_g/2^Mg) * 2^-exp_g`` exactly.
    """
    # ratios below 2^-120 mean an (almost) all-zero group; fp32 powers of
    # two end near there, so the exponent is clamped (exact in effect)
    e_min = max(gs_fmt.e_min, -120)
    e, frac = exponent_fraction(s_gf)
    too_small = e < e_min
    e = e.clamp(e_min, 0)
    frac = torch.where(too_small, torch.ones_like(frac), frac)
    man = torch.ceil((frac - 1.0) * 2.0**gs_fmt.m).to(torch.int32)
    overflow = man >= 2**gs_fmt.m  # frac_q == 2: bump the exponent
    man = torch.where(overflow, torch.zeros_like(man), man)
    e = torch.where(overflow, e + 1, e).clamp(e_min, 0)
    s_g = (1.0 + man.to(torch.float32) * 2.0**-gs_fmt.m) * pow2(e)
    return s_g, (-e).to(torch.int32), man


def quantize_elements(
    x_f: torch.Tensor, fmt: EMFormat, r: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize normalized magnitudes in [0, 1] to the <E,M> grid.

    Paper Alg. 2 lines 9-16: per-element exponent, mantissa rounding
    (stochastic with the U[-1/2, 1/2) tensor ``r``, nearest when ``None``),
    gradual underflow at ``e_min`` and saturation at the top of the grid.
    Returns ``(xbar, exp_stored, man)``, ``xbar`` exactly on the grid.
    """
    x_f = x_f.to(torch.float32)
    if fmt.e == 0:  # plain fixed point: uniform grid man/2^M over [0, 1)
        step = 2.0**-fmt.m
        scaled = x_f / step
        q = torch.floor((scaled + r if r is not None else scaled) + 0.5)
        xbar = q.clamp(0.0, 2.0**fmt.m - 1.0) * step
    else:
        e, _ = exponent_fraction(x_f)
        e_eff = e.clamp(fmt.e_min, -1)
        # grid spacing at this exponent level (denormals share e_min's step)
        step = pow2(e_eff - fmt.m)
        scaled = x_f / step
        q = torch.floor((scaled + r if r is not None else scaled) + 0.5)
        # at e_eff == -1 the next exponent does not exist: saturate there;
        # below it, q == 2^(M+1) rounds up into the next exponent level
        qmax = torch.where(
            e_eff == -1,
            torch.full_like(q, 2.0 ** (fmt.m + 1) - 1.0),
            torch.full_like(q, 2.0 ** (fmt.m + 1)),
        )
        xbar = torch.minimum(q.clamp_min(0.0), qmax) * step

    # exact storage fields from the on-grid value
    e2, frac2 = exponent_fraction(xbar)
    is_normal = e2 >= fmt.e_min
    man = torch.where(
        is_normal,
        torch.round((frac2 - 1.0) * 2.0**fmt.m),
        torch.round(xbar * 2.0 ** (fmt.m - fmt.e_min)),
    ).to(torch.int32)
    # stored 0 flags the denormal level; stored s in [1, 2^E - 1] is e = -s
    exp_stored = torch.where(is_normal, -e2, torch.zeros_like(e2)).to(torch.int32)
    return xbar, exp_stored, man
