"""Layer ops of the port: conv, linear, batchnorm and the residual add.

Conv and linear take an optional :class:`QuantConfig`; when given (and
enabled) the op runs all three training GEMMs in the MLS quantized domain
(paper Alg. 1), otherwise it is a plain fp32 op.  ``key`` seeds the site's
stochastic-rounding streams (``None``: deterministic).  Layouts follow the
JAX package: NCHW activations, OIHW conv weights, (d_in, d_out) linear
weights.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.lowbit import QuantConfig
from repro_torch.kernels.implicit_conv import conv_pads
from repro_torch.kernels.lowbit_conv import lowbit_conv_fused, lowbit_matmul_qd

__all__ = ["batchnorm", "conv2d", "ew_add", "linear"]


def ew_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Element-wise residual add."""
    return a + b


def linear(x, w, b=None, qcfg: QuantConfig | None = None, key=None) -> torch.Tensor:
    """``x (..., d_in) @ w (d_in, d_out)``; the bias is added in fp32."""
    if qcfg is not None and qcfg.enabled:
        y = lowbit_matmul_qd(x, w.float(), key, qcfg)
    else:
        y = x.float() @ w.float()
    return y if b is None else y + b.float()


def conv2d(x, w, stride=1, padding="SAME", qcfg: QuantConfig | None = None,
           key=None) -> torch.Tensor:
    """NCHW conv with JAX's padding rule; quantized per paper Alg. 1 when
    ``qcfg`` is given."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    if qcfg is not None and qcfg.enabled:
        return lowbit_conv_fused(x, w, key, s, padding, qcfg)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads(x.shape[2:], w.shape[2:], s, padding)
    return F.conv2d(F.pad(x.float(), (pw_lo, pw_hi, ph_lo, ph_hi)), w.float(), stride=s)


def batchnorm(x, gamma, beta, eps: float = 5e-5) -> torch.Tensor:
    """Training-mode BN over (N, H, W) of NCHW in fp32, no running
    statistics; ``var = E[x^2] - mu^2`` and eps as in paper Eq. 13."""
    x = x.float()
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = (x * x).mean(dim=(0, 2, 3), keepdim=True) - mu * mu
    y = (x - mu) * torch.rsqrt(var + eps)
    return y * gamma[None, :, None, None] + beta[None, :, None, None]
