"""Integer bit widths of the kernels' accumulations.

The quantized-domain GEMMs (K3 ``csrc/mls_matmul.cu``, K4
``csrc/implicit_conv.cu``) sum ``k_block`` products of decoded code
fractions per scaling group in int32 and convert the sum to fp32; both
steps are exact only while the sum stays below ``2^24`` (paper Sec. V-B).

The JAX package proves such bounds by abstract interpretation of the
traced kernel body (``abstract_eval_jaxpr``).  A CUDA body cannot be
traced, so the port has no interpreter: each launch descriptor
(:class:`repro_torch.kernels.launch.LaunchSpec`) declares its kernel's
accumulations as :class:`Accumulation` records, and the verifier
(:mod:`repro_torch.analysis.kernel_verify`) checks their widths.
"""
from __future__ import annotations

import dataclasses
import math

__all__ = ["Accumulation", "integer_bits"]

_INF = float("inf")


def integer_bits(hi: float) -> int:
    """Unsigned integer bits needed for magnitudes up to ``hi``:
    ``ceil(log2(hi + 1))``."""
    if hi == _INF:
        return 1 << 30
    return max(int(math.ceil(hi)), 0).bit_length()


@dataclasses.dataclass(frozen=True)
class Accumulation:
    """One accumulation a kernel performs, per output element.

    ``kind`` is ``"dot"``: a sum of ``depth`` products of two operands whose
    magnitudes are at most ``operand_bound`` (a format's ``max_fraction``
    for decoded codes).  Only *integer* accumulations carry the
    fp32-exactness obligation; float ones are recorded with
    ``integer=False`` and not gated.
    """

    kind: str
    depth: int
    operand_bound: float
    integer: bool = True

    @property
    def bound(self) -> float:
        """Largest magnitude of the sum: ``depth * operand_bound**2``."""
        return self.depth * self.operand_bound**2

    @property
    def bits(self) -> int:
        """Integer bits of the sum by the rule of ``accumulation_bits``: a
        product's bits plus ``ceil(log2(depth))``.  Never below
        ``integer_bits(bound)`` and at most one bit above it, so the
        verifier, the lint and ``QuantConfig`` refuse the same pairs."""
        return integer_bits(self.operand_bound**2) + (self.depth - 1).bit_length()

    def to_json(self) -> dict:
        def num(v):
            return v if v != _INF else "inf"

        return {"kind": self.kind, "bound": num(self.bound),
                "bits": min(self.bits, 9999), "integer": self.integer,
                "depth": self.depth, "operand_bound": num(self.operand_bound)}
