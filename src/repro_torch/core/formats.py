"""Custom ``<E,M>`` floating-point format math (paper Sec. IV-A, V-C).

A value in the (unsigned) ``<E,M>`` format is

    normal   : (1 + Man/2^M) * 2^e      e in [e_min, -1],  Man in [0, 2^M)
    denormal : (    Man/2^M) * 2^e_min  (gradual underflow, IEEE-754 style)

with ``e_min = 1 - 2^E`` (``E == 0`` is plain fixed point ``Man/2^M``).  The
exponent is stored as ``-e`` in E bits; stored 0 flags the denormal level.
All representable magnitudes lie in ``[0, (2 - 2^-M) * 2^-1] ⊂ [0, 1)``.

The same math implements the group-scale format ``<Eg,Mg>`` (Mg ∈ {0,1});
there the fraction is *ceil*-rounded and the value may be exactly 1, see
:func:`repro_torch.core.quantize.quantize_group_scale`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

__all__ = [
    "EMFormat",
    "FMT_CIFAR",
    "FMT_IMAGENET",
    "GS_FMT_DEFAULT",
    "accumulation_bits",
    "exponent_fraction",
    "pow2",
]


@dataclasses.dataclass(frozen=True)
class EMFormat:
    """Bit layout of a ``<E,M>`` unsigned low-bit float."""

    e: int  # exponent bits
    m: int  # mantissa bits

    def __post_init__(self):
        if self.e < 0 or self.m < 0 or (self.e == 0 and self.m == 0):
            raise ValueError(f"invalid <E,M> format <{self.e},{self.m}>")

    @property
    def e_min(self) -> int:
        """Most negative normal exponent (== denormal exponent); 0 for the
        fixed-point formats (E == 0), whose grid is ``man/2^M``."""
        return 1 - 2**self.e if self.e > 0 else 0

    @property
    def max_value(self) -> float:
        """Largest representable magnitude."""
        if self.e == 0:
            return (2.0**self.m - 1.0) / 2.0**self.m
        return (2.0 - 2.0 ** (-self.m)) * 0.5

    @property
    def element_bits(self) -> int:
        """Storage bits per signed element (sign + exponent + mantissa)."""
        return 1 + self.e + self.m

    @property
    def product_bits(self) -> int:
        """Integer bit-width of a product of two <E,M> values (paper §V-C):
        ``2M + 2^(E+1) - 2`` bits."""
        return 2 * self.m + 2 ** (self.e + 1) - 2

    @property
    def max_fraction(self) -> int:
        """Largest |integer fraction| of a decoded code: ``|value| = |F| *
        2^(e_min - M)`` (:func:`repro_torch.kernels.ref.decode_frac_int`)."""
        if self.e == 0:
            return 2**self.m - 1
        return (2 ** (self.m + 1) - 1) << (2**self.e - 2)

    def grid(self) -> np.ndarray:
        """All representable non-negative values, ascending (for tests)."""
        vals = {0.0}
        for man in range(2**self.m):  # denormals (all values for E == 0)
            vals.add((man / 2**self.m) * 2.0**self.e_min)
        n_exp_levels = 2**self.e - 1 if self.e > 0 else 0
        for k in range(n_exp_levels):  # normals: e = e_min + k .. -1
            e = self.e_min + k
            for man in range(2**self.m):
                vals.add((1 + man / 2**self.m) * 2.0**e)
        return np.array(sorted(vals))

    def __str__(self) -> str:  # the paper's ⟨E,M⟩ notation
        return f"<{self.e},{self.m}>"


def accumulation_bits(fmt: EMFormat, k_block: int) -> int:
    """Integer bits spanned by a sum of ``k_block`` products of two ``fmt``
    values: ``product_bits + ceil(log2(k_block))``.  A scaling group's sum is
    exact in fp32 (and its int32 sum converts to fp32 exactly) only while
    this stays below 24."""
    if k_block < 1:
        raise ValueError(f"k_block must be >= 1, got {k_block}")
    return fmt.product_bits + math.ceil(math.log2(k_block))


# Paper's headline configurations (Table II).
FMT_CIFAR = EMFormat(e=2, m=1)  # <2,1>
FMT_IMAGENET = EMFormat(e=2, m=4)  # <2,4>
GS_FMT_DEFAULT = EMFormat(e=8, m=1)  # group scale <8,1>

_ZERO_EXP = -(2**30)  # exponent reported for zero / fp32-subnormal inputs


def exponent_fraction(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``Exponent``/``Fraction`` of paper Alg. 2: ``x = frac * 2^e``,
    ``frac ∈ [1, 2)``, read from the float32 bits (never ``log2``).

    Zero and fp32-subnormal inputs map to ``(e=-2^30, frac=0)``, which the
    callers' clipping turns into zero.  ``x`` must be non-negative.
    """
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    raw_exp = (bits >> 23) & 0xFF
    bad = raw_exp == 0
    e = torch.where(bad, torch.full_like(raw_exp, _ZERO_EXP), raw_exp - 127)
    frac = ((bits & 0x7FFFFF) | (127 << 23)).view(torch.float32)
    frac = torch.where(bad, torch.zeros_like(frac), frac)
    return e, frac


def pow2(e: torch.Tensor) -> torch.Tensor:
    """Exact float32 ``2^e`` for an int32 tensor, built from the exponent
    bits (subnormal results included, 0 below 2^-149, +inf above 2^127).

    ``jnp.exp2`` on XLA's CPU backend is not exact for integer exponents
    at or below -15; the port never routes a power of two through it.
    """
    e = e.to(torch.int32)
    normal = ((e.clamp(-126, 128) + 127) << 23).view(torch.float32)
    sub = (torch.ones_like(e) << (e + 149).clamp(0, 22)).view(torch.float32)
    sub = torch.where(e < -149, torch.zeros_like(sub), sub)
    return torch.where(e >= -126, normal, sub)
