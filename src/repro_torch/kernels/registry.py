"""Registry of the port's kernel entry points, under the JAX package's entry
names (``repro.kernels.registry``, with ``mls_quantize`` and ``mls_matmul``
for its ``*_pallas`` wrappers) and at its example shapes.

The static verifier (:mod:`repro_torch.analysis.kernel_verify`) runs each
entry once on a device, forward and, where ``needs_grad``, backward, and
proves every launch the wrappers recorded.  The JAX entries' autotuning
specs (``tune``) wait for the port's autotuner (ROADMAP queue 1, item 7).
"""
from __future__ import annotations

import collections
import dataclasses
from collections.abc import Callable

import torch

from repro_torch.core.formats import FMT_IMAGENET, GS_FMT_DEFAULT
from repro_torch.core.lowbit import GROUPINGS, QuantConfig

from . import launch
from .lowbit_conv import lowbit_conv_fused, lowbit_matmul_qd, qd_gemm
from .mls_matmul import mls_matmul
from .mls_quantize import mls_quantize

__all__ = ["KERNEL_REGISTRY", "KernelEntry"]


@dataclasses.dataclass(frozen=True)
class KernelEntry:
    """One verifiable kernel entry point: ``fn`` applied to example inputs of
    ``shapes`` (``uint8`` code tensors where the shape's dtype says so).
    ``needs_grad`` marks training ops whose backward GEMMs are verified
    too."""

    name: str
    description: str
    fn: Callable
    shapes: tuple[tuple[tuple[int, ...], torch.dtype], ...]
    needs_grad: bool = False

    def example_args(self, device, seed: int = 0) -> list[torch.Tensor]:
        """Seeded example inputs on ``device``: normal floats, uint8 codes
        below 128 (7-bit <2,4> codes)."""
        gen = torch.Generator().manual_seed(seed)
        args = []
        for shape, dtype in self.shapes:
            if dtype == torch.uint8:
                t = torch.randint(0, 128, shape, generator=gen, dtype=torch.uint8)
            else:
                t = torch.randn(shape, generator=gen)
            args.append(t.to(device).requires_grad_(self.needs_grad and t.is_floating_point()))
        return args

    def run(self, device) -> collections.Counter:
        """Run the entry once on ``device`` (forward, then backward with a
        ones cotangent when ``needs_grad``); the launches it recorded."""
        before = collections.Counter(launch.RECORDED)
        y = self.fn(*self.example_args(device))
        if self.needs_grad:
            y.backward(torch.ones_like(y))
        return collections.Counter(launch.RECORDED) - before


_F32, _U8 = torch.float32, torch.uint8


def _quantize(x):
    # every grouping: K1 ("nc", "n") and K2 ("c", "none")
    for grouping in GROUPINGS:
        mls_quantize(x, FMT_IMAGENET, 128, grouping=grouping)


def _matmul(xc, wc):
    kb = 128  # unit scales in the "nc" layouts
    xsg = torch.ones((xc.shape[0], xc.shape[1] // kb), device=xc.device)
    wsg = torch.ones((wc.shape[0] // kb, wc.shape[1]), device=xc.device)
    st = torch.ones((), device=xc.device)
    return mls_matmul(xc, xsg, st, wc, wsg, st, FMT_IMAGENET, kb)


def _matmul_fused(x, w):
    return qd_gemm(x, w, None, None, fmt=FMT_IMAGENET, gs_fmt=GS_FMT_DEFAULT, k_block=128,
                   grouping="nc")


_CONV_CFG = QuantConfig(fmt=FMT_IMAGENET, stochastic=False, k_block=32, conv_impl="im2col")


def _conv_implicit(x, w):
    # every grouping, each with K4's own scale passes; k_block = cb*kh*kw =
    # 4*3*3, the implicit grouping for C=16 3x3 convs
    return sum(lowbit_conv_fused(x, w, None, (1, 1), "SAME", QuantConfig(
        fmt=FMT_IMAGENET, stochastic=False, k_block=36, conv_impl="implicit", grouping=g))
        for g in GROUPINGS)


KERNEL_REGISTRY: dict[str, KernelEntry] = {
    e.name: e
    for e in (
        KernelEntry("mls_quantize", "MLS dynamic quantization (paper Alg. 2), all four "
                    "groupings", _quantize, (((256, 512), _F32),)),
        KernelEntry("mls_matmul", "quantized-domain GEMM (paper Eq. 6-8)", _matmul,
                    (((256, 512), _U8), ((512, 256), _U8))),
        KernelEntry("lowbit_matmul_fused", "dynamic-quantize-both-operands GEMM (qd_gemm)",
                    _matmul_fused, (((256, 512), _F32), ((512, 256), _F32))),
        KernelEntry("lowbit_conv_fused", "im2col conv with fwd/wgrad/dgrad quantized GEMMs "
                    "(paper Alg. 1)",
                    lambda x, w: lowbit_conv_fused(x, w, None, (1, 1), "SAME", _CONV_CFG),
                    (((2, 16, 8, 8), _F32), ((16, 16, 3, 3), _F32)), needs_grad=True),
        KernelEntry("lowbit_conv_implicit", "implicit-GEMM conv, quantize fused into the "
                    "GEMM prologue (no materialized im2col), all four groupings",
                    _conv_implicit, (((2, 16, 8, 8), _F32), ((16, 16, 3, 3), _F32)),
                    needs_grad=True),
        KernelEntry("lowbit_matmul_qd", "linear-layer training op, all three GEMMs "
                    "quantized-domain",
                    lambda x, w: lowbit_matmul_qd(x, w, None, _CONV_CFG),
                    (((64, 96), _F32), ((96, 64), _F32)), needs_grad=True),
    )
}
