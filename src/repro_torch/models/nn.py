"""Layer ops of the port: conv, linear, batchnorm and the residual add.

Conv and linear take an optional :class:`QuantConfig`; when given (and
enabled) the op runs all three training GEMMs through the paper's low-bit
path (Alg. 1) with the config's ``backend``: ``"quantized"`` in the MLS
quantized domain on the CUDA kernels, ``"fake_quant"`` as fp32 ops on
fake-quantized operands.  Otherwise it is a plain fp32 op.  ``key`` seeds
the site's stochastic-rounding streams (``None``: deterministic).  Layouts
follow the JAX package: NCHW activations, OIHW conv weights, (d_in, d_out)
linear weights.

:class:`OpTrace` records ``(kind, dims)`` for every conv, linear, BN and
residual add run inside it, as the JAX package's does: run a model under
it on the ``meta`` device to count the paper's Table I / VI operations
without allocating memory.  It also lists each conv's launch geometry
(``convs``), from which the kernel launches of a step follow.
"""
from __future__ import annotations

import contextvars

import torch

from repro_torch.core.lowbit import QuantConfig, conv2d_fp32, lowbit_conv, lowbit_matmul
from repro_torch.kernels.lowbit_conv import lowbit_conv_fused, lowbit_matmul_qd

__all__ = ["OpTrace", "batchnorm", "conv2d", "ew_add", "linear"]

_OP_TRACE: contextvars.ContextVar[tuple[list, list] | None] = contextvars.ContextVar(
    "op_trace", default=None)


class OpTrace:
    """Context manager that records ``(op, dims)`` for every conv, linear,
    BN and residual add run inside it (``.ops`` after the block), and for
    every conv ``(x shape, w shape, stride, padding, site)`` (``.convs``),
    ``site`` telling whether the conv was given a ``QuantConfig`` (enabled
    or not)."""

    def __enter__(self):
        self._token = _OP_TRACE.set(([], []))
        return self

    def __exit__(self, *exc):
        self.ops, self.convs = _OP_TRACE.get()
        _OP_TRACE.reset(self._token)
        return False


def _trace(kind: str, **dims) -> None:
    trace = _OP_TRACE.get()
    if trace is not None:
        trace[0].append((kind, dims))


def _quantized(qcfg: QuantConfig | None) -> bool:
    return qcfg is not None and qcfg.enabled


def ew_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise residual add (traced: paper Table I counts these)."""
    _trace("ew_add", numel=a.numel())
    return a + b


def linear(x, w, b=None, qcfg: QuantConfig | None = None, key=None) -> torch.Tensor:
    """``x (..., d_in) @ w (d_in, d_out)``; the bias is added in fp32."""
    _trace("fc", d_in=w.shape[0], d_out=w.shape[1], rows=x.numel() // x.shape[-1],
           quantized=_quantized(qcfg))
    if _quantized(qcfg):
        fn = lowbit_matmul_qd if qcfg.backend == "quantized" else lowbit_matmul
        y = fn(x, w.float(), key, qcfg)
    else:
        y = x.float() @ w.float()
    return y if b is None else y + b.float()


def conv2d(x, w, stride=1, padding="SAME", qcfg: QuantConfig | None = None,
           key=None) -> torch.Tensor:
    """NCHW conv with JAX's padding rule; quantized per paper Alg. 1 when
    ``qcfg`` is given."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    co, ci, kh, _ = w.shape
    _trace("conv", c_in=ci, c_out=co, k=kh, h=x.shape[2] // s[0], w=x.shape[3] // s[1],
           n=x.shape[0], quantized=_quantized(qcfg))
    trace = _OP_TRACE.get()
    if trace is not None:
        trace[1].append((tuple(x.shape), tuple(w.shape), s, padding, qcfg is not None))
    if _quantized(qcfg):
        fn = lowbit_conv_fused if qcfg.backend == "quantized" else lowbit_conv
        return fn(x, w, key, s, padding, qcfg)
    return conv2d_fp32(x, w, s, padding)


def batchnorm(x, gamma, beta, eps: float = 5e-5) -> torch.Tensor:
    """Training-mode BN over (N, H, W) of NCHW in fp32, no running
    statistics; ``var = E[x^2] - mu^2`` and eps as in paper Eq. 13."""
    _trace("bn", numel=x.numel())
    x = x.float()
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x * x).mean(dim=(0, 2, 3), keepdim=True) - mu * mu
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * gamma[None, :, None, None] + beta[None, :, None, None]
