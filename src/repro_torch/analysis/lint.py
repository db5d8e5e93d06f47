"""Numerics legality lint for the port's ``QuantConfig``/``EMFormat`` pairs.

Static checks that a quantization configuration runs *exactly* on the
arithmetic the kernels assume:

* **Accumulator exactness.**  K3 and K4 sum a scaling group's integer
  products in int32 and convert the sum to fp32, exact only below 2^24:
  ``product_bits + ceil(log2(k_block)) < 24``.
* **Code width.**  Packed codes (sign, exponent, mantissa) must fit a
  byte: ``1 + E + M <= 8``.
* **Tiling.**  K3 contracts each scaling group in ``kKStep``-wide (16)
  tensor-core k steps and stages its codes with 16-byte ``cp.async``
  copies (``csrc/mls_matmul.cu``); a ``k_block`` that is not a multiple of
  ``kKStep`` leaves the last step of every group part empty and stages the
  codes with plain loads.  The kernels take any ``k_block``, so this is a
  warning.  The JAX package's rule here (a power of two in [16, 512] for
  the Pallas contraction tile) does not apply to the port.
* **Grouping and group-scale format.**  The grouping must name a known
  layout; the group-scale fraction must stay within the shift-add budget of
  the inter-group combine (``Mg <= 2``).

Pure Python on dataclass fields: it runs on any host.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.formats import EMFormat, accumulation_bits
from repro_torch.core.lowbit import GROUPINGS, QuantConfig
from repro_torch.kernels.mls_matmul import TILE

__all__ = [
    "LintResult",
    "check_format_pair",
    "lint_quant_config",
    "lint_shipped_presets",
]


@dataclasses.dataclass
class LintResult:
    errors: list[str]
    warnings: list[str]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> dict:
        return {"ok": self.ok, "errors": self.errors, "warnings": self.warnings}


def check_format_pair(fmt: EMFormat, k_block: int) -> list[str]:
    """Errors for an element format x accumulation depth pair."""
    errors = []
    if k_block < 1:
        errors.append(f"k_block must be >= 1, got {k_block}")
        return errors
    acc = accumulation_bits(fmt, k_block)
    if acc >= 24:
        errors.append(
            f"accumulating {k_block} products of {fmt} values needs {acc} "
            f"integer bits (product_bits={fmt.product_bits} + "
            f"ceil(log2(k_block))) >= 24: fp32 accumulation is no longer "
            f"bit-exact — shrink k_block or the ⟨E,M⟩ format"
        )
    if fmt.element_bits > 8:
        errors.append(
            f"{fmt} needs {fmt.element_bits} storage bits per element; the "
            f"packed code layout (sign|exp|man) is uint8 — max 8"
        )
    return errors


def lint_quant_config(cfg: QuantConfig) -> LintResult:
    """Full legality lint of one ``QuantConfig``."""
    errors = list(check_format_pair(cfg.fmt, cfg.k_block))
    warnings: list[str] = []

    margin = 24 - accumulation_bits(cfg.fmt, cfg.k_block)
    if 0 < margin <= 1:
        warnings.append(
            f"only {margin} bit of fp32 accumulator headroom for "
            f"{cfg.fmt} × k_block={cfg.k_block}; a 2x deeper group would "
            f"break exactness"
        )

    if cfg.grouping not in GROUPINGS:
        errors.append(
            f"unknown grouping {cfg.grouping!r}; expected one of "
            f"{GROUPINGS}"
        )

    if cfg.gs_fmt.m > 2:
        errors.append(
            f"group-scale format {cfg.gs_fmt} has Mg={cfg.gs_fmt.m} > 2: the "
            f"inter-group combine budgets <= 3 shifted adds per scale "
            f"(paper Sec. V-B); use Mg in {{0, 1, 2}}"
        )
    if cfg.gs_fmt.e < 4:
        warnings.append(
            f"group-scale format {cfg.gs_fmt} spans scale ratios only down "
            f"to 2^{cfg.gs_fmt.e_min}; groups quieter than that underflow to "
            f"the denormal level"
        )

    ks = TILE["kKStep"]
    if cfg.k_block % ks:
        steps = -(-cfg.k_block // ks)
        warnings.append(
            f"k_block={cfg.k_block} is not a multiple of K3's {ks}-wide k step: each "
            f"scaling group runs {steps} steps with {steps * ks - cfg.k_block} of "
            f"{steps * ks} slots empty, and its codes are staged without cp.async"
        )

    return LintResult(errors, warnings)


def lint_shipped_presets() -> dict[str, LintResult]:
    """Lint every QuantConfig the port's trainer ships
    (``python -m repro_torch.train --fmt ...``, :func:`train.loop.preset`)."""
    from repro_torch.train.loop import DEFAULT_FMTS, parse_fmt, preset

    return {f"train:mls{parse_fmt(s)}": lint_quant_config(preset(parse_fmt(s)))
            for s in DEFAULT_FMTS}
