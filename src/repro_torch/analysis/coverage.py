"""Quantized-domain coverage of a PyTorch program run.

The paper's energy argument (Sec. VII) needs *every* hot-path MAC to run on
MLS low-bit operands: one silently unquantized matmul voids it.  This
module runs a program under a ``TorchDispatchMode`` and classifies its MACs:

* ``quantized``: the launches of the quantized-domain kernels (K3
  ``mls_matmul``, K4 ``implicit_conv``), counted from the launch records
  their wrappers make (:mod:`repro_torch.kernels.launch`), at the MACs of
  each launch's descriptor: ``M * N * K`` as launched, K padded to a
  multiple of ``k_block``.  On the CPU a wrapper runs its kernel's plain
  version; the PyTorch ops inside it are not counted again.
* ``data_movement``: ``aten.im2col`` / ``aten.col2im`` (``F.unfold`` /
  ``F.fold``), the patch gather and its transpose, at one "MAC" per
  element moved; reported, never part of the fraction.  (The port's own
  col2im is a loop of strided adds, which carries no MACs.)
* ``full_precision``: every other FLOP-bearing aten op (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``convolution`` and
  ``convolution_backward``): the unquantized stem conv and classifier, or
  a planted fp32 GEMM.

``quantized_fraction = quantized / (quantized + full_precision)`` is what
the gate compares with ``baselines/gate.json``.
"""
from __future__ import annotations

import collections
import dataclasses
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import launch, recorded_specs

__all__ = ["CoverageReport", "Site", "coverage_of_run"]

_aten = torch.ops.aten
_MM = {_aten.mm.default, _aten.addmm.default, _aten.bmm.default, _aten.baddbmm.default}
_MOVES = {_aten.im2col.default, _aten.col2im.default}


@dataclasses.dataclass
class Site:
    """One FLOP-bearing op or kernel launch (weighted by its count)."""

    path: str  # aten op or "kernel:<C entry point>"
    kind: str  # "dot" | "conv"
    klass: str  # "quantized" | "full_precision" | "data_movement"
    macs: int
    out_shape: tuple

    def to_json(self) -> dict:
        return {"path": self.path, "kind": self.kind, "class": self.klass,
                "macs": self.macs, "out_shape": list(self.out_shape)}


@dataclasses.dataclass
class CoverageReport:
    sites: list[Site]

    def _total(self, klass: str) -> int:
        return sum(s.macs for s in self.sites if s.klass == klass)

    @property
    def quantized_macs(self) -> int:
        return self._total("quantized")

    @property
    def full_precision_macs(self) -> int:
        return self._total("full_precision")

    @property
    def data_movement_macs(self) -> int:
        return self._total("data_movement")

    @property
    def quantized_fraction(self) -> float:
        denom = self.quantized_macs + self.full_precision_macs
        return self.quantized_macs / denom if denom else 0.0

    def full_precision_sites(self) -> list[Site]:
        return sorted((s for s in self.sites if s.klass == "full_precision"),
                      key=lambda s: -s.macs)

    def to_json(self, top_sites: int = 24) -> dict:
        ranked = sorted(self.sites, key=lambda s: -s.macs)
        return {
            "quantized_macs": self.quantized_macs,
            "full_precision_macs": self.full_precision_macs,
            "data_movement_macs": self.data_movement_macs,
            "quantized_fraction": round(self.quantized_fraction, 6),
            "n_sites": len(self.sites),
            "sites": [s.to_json() for s in ranked[:top_sites]],
            "full_precision_sites": [s.to_json() for s in self.full_precision_sites()[:top_sites]],
        }


def _conv_macs(out_shape, weight_shape) -> int:
    """Output elements x the weight's (C_in / groups) x kernel taps."""
    return math.prod(out_shape) * math.prod(weight_shape[1:])


class _Classifier(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.macs: collections.Counter = collections.Counter()  # (path, kind, class, shape)

    def _add(self, path: str, kind: str, klass: str, macs: int, out_shape) -> None:
        self.macs[(path, kind, klass, tuple(out_shape))] += macs

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if launch.in_plain_version():
            return out
        if func in _MM:  # (..., a, b): out elements x contraction depth
            self._add(str(func), "dot", "full_precision", out.numel() * args[-2].shape[-1],
                      out.shape)
        elif func is _aten.convolution.default:
            self._add(str(func), "conv", "full_precision",
                      _conv_macs(out.shape, args[1].shape), out.shape)
        elif func is _aten.convolution_backward.default:  # input and/or weight gradient
            grad_out, weight, mask = args[0], args[2], args[-1]
            fwd = _conv_macs(grad_out.shape, weight.shape)
            self._add(str(func), "conv", "full_precision", fwd * (int(mask[0]) + int(mask[1])),
                      grad_out.shape)
        elif func in _MOVES:
            moved = out.numel() if func is _aten.im2col.default else args[0].numel()
            self._add(str(func), "conv", "data_movement", moved, out.shape)
        return out


def coverage_of_run(fn) -> tuple[CoverageReport, collections.Counter]:
    """Run ``fn()`` and classify its MACs.  Returns the report and the
    kernel launches ``fn`` recorded (for the verifier)."""
    before = collections.Counter(launch.RECORDED)
    mode = _Classifier()
    with mode:
        fn()
    records = collections.Counter(launch.RECORDED) - before
    sites = [Site(*key[:3], macs, key[3]) for key, macs in mode.macs.items()]
    for spec, n in recorded_specs(records):
        if spec.macs:
            out = next(o for o in spec.operands if o.output)
            sites.append(Site(f"kernel:{spec.kernel}", "dot", "quantized", spec.macs * n,
                              out.shape))
    return CoverageReport(sites), records
