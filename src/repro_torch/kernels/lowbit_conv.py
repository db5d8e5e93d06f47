"""Quantized-domain low-bit convolution and matmul.

The training hot path of paper Alg. 1 on the real quantized-domain
pipeline (:func:`mls_quantize` -> :func:`mls_matmul`).  All three training
convolutions are MLS GEMMs over the im2col layout:

    forward : Z  = Cols(qA) @ qW            (Alg. 1 l.4)
    wgrad   : G  = Cols(qA)^T @ qE          (Alg. 1 l.13)
    dgrad   : dA = col2im(qE @ qW^T), STE   (Alg. 1 l.15-16)

Each GEMM quantizes its operands dynamically with scaling groups of
``k_block`` elements along its own contraction axis (the matmul analogue of
the paper's (n, c) grouping), so the three GEMMs use three group layouts of
the same logical operands.  Stochastic rounding draws GEMM operand ``idx``
(0-5) from its own stream, ``rounding_generator(key, cfg, idx)``.

The forward conv has two lowerings that compute the same numbers:
"im2col" (patch matrix, then quantize and GEMM; any ``k_block``) and
"implicit" (:mod:`.implicit_conv`: one kernel that gathers and quantizes
the patches in its GEMM prologue; ``k_block = cb*kh*kw`` with ``cb | C``),
chosen by :func:`~.implicit_conv.resolve_conv_impl`.  On the implicit path
with grouping "none" and deterministic rounding, the weight gradient
reuses the forward codes: tensor-wise quantization commutes with the patch
gather, so the input is coded once and its codes gathered as bytes instead
of quantizing the fp32 patch matrix again (:func:`_qd_gemm_precoded_x`).

Padding follows JAX's rule, which pads "SAME" asymmetrically at stride 2
(lo 0, hi 1 on ResNet-20's 3x3/stride-2 convs): ``implicit_conv.conv_pads``
resolves it and ``F.pad`` applies it, since ``F.unfold`` pads only
symmetrically.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import EMFormat
from repro_torch.core.lowbit import QuantConfig, rounding_generator

from .implicit_conv import (
    conv_geometry,
    covered_tensor_scale,
    elementwise_codes,
    implicit_conv_forward,
    patches_u8,
    resolve_conv_impl,
)
from .mls_matmul import mls_matmul
from .mls_quantize import mls_quantize, rounding_bytes
from .ref import Pads, im2col

__all__ = [
    "LowbitConvFused",
    "LowbitMatmulQD",
    "lowbit_conv_fused",
    "lowbit_matmul_qd",
    "qd_gemm",
]


# ---------------------------------------------------------------------------
# Core quantized-domain GEMM
# ---------------------------------------------------------------------------
def qd_gemm(
    x2d: torch.Tensor,
    w2d: torch.Tensor,
    gen_x: torch.Generator | None,
    gen_w: torch.Generator | None,
    *,
    fmt: EMFormat,
    gs_fmt: EMFormat,
    k_block: int,
    grouping: str,
) -> torch.Tensor:
    """Quantize ``x (M, K)`` / ``w (K, N)`` dynamically and contract.

    K is zero-padded to a multiple of ``k_block`` (exact: padded codes are
    0, and zeros never raise a group maximum); ragged M/N need no padding,
    the GEMM kernel masks them.  The weight is quantized transposed, so its
    groups run along K, and its codes/scales are handed over as transposed
    views: exactly the GEMM-side compact layout for every grouping.
    """
    M, K = x2d.shape
    if w2d.shape[0] != K:
        raise ValueError(f"contraction mismatch {tuple(x2d.shape)} @ {tuple(w2d.shape)}")
    pk = (-K) % k_block
    xp = F.pad(x2d.float(), (0, pk)).contiguous()
    wt = F.pad(w2d.float().t(), (0, pk)).contiguous()  # (N, K + pk)
    xc, xsg, xst = mls_quantize(xp, fmt, k_block, gs_fmt,
                                rounding_bytes(xp.shape, gen_x, xp.device), grouping)
    wc, wsgT, wst = mls_quantize(wt, fmt, k_block, gs_fmt,
                                 rounding_bytes(wt.shape, gen_w, wt.device), grouping)
    return mls_matmul(xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, k_block, grouping)


def _gemm_kwargs(cfg: QuantConfig) -> dict:
    return dict(fmt=cfg.fmt, gs_fmt=cfg.gs_fmt, k_block=cfg.k_block, grouping=cfg.grouping)


# ---------------------------------------------------------------------------
# col2im: the transpose of the patch gather
# ---------------------------------------------------------------------------
def _col2im(dcols: torch.Tensor, x_shape, ksize, stride, pads: Pads, out_hw) -> torch.Tensor:
    """Exact transpose of :func:`~.ref.im2col`: scatter-add of the patch
    cotangents.

    The taps are added one after another in reverse order, (kh-1, kw-1)
    first: the order in which XLA's transposed patch convolution sums a
    3x3 window on the CPU, so the JAX package's gradients are reproduced
    bit for bit on the 3x3 and 1x1 convs of ResNet.  (``F.fold`` sums in
    another order.)
    """
    n, oh, ow = out_hw
    _, c, h, w = x_shape
    kh, kw = ksize
    sh, sw = stride
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
    d = dcols.reshape(n, oh, ow, c, kh, kw).permute(0, 3, 4, 5, 1, 2)
    out = dcols.new_zeros((n, c, h + ph_lo + ph_hi, w + pw_lo + pw_hi))
    for i in reversed(range(kh)):
        for j in reversed(range(kw)):
            out[:, :, i : i + sh * (oh - 1) + 1 : sh, j : j + sw * (ow - 1) + 1 : sw] += d[:, :, i, j]
    return out[:, :, ph_lo : ph_lo + h, pw_lo : pw_lo + w]


# ---------------------------------------------------------------------------
# Fused conv: forward and backward pipelines
# ---------------------------------------------------------------------------
def _conv_fwd_impl(x, w, key, stride, padding, cfg: QuantConfig):
    geom = conv_geometry(x.shape, w.shape, stride, padding)
    gen_x = rounding_generator(key, cfg, 0, x.device)
    gen_w = rounding_generator(key, cfg, 1, x.device)
    if resolve_conv_impl(geom, cfg) == "implicit":
        # the im2col path's rounding streams and shapes: same numbers
        return implicit_conv_forward(
            x, w, rounding_bytes((geom.m0, geom.k0), gen_x, x.device),
            rounding_bytes((geom.o, geom.k0), gen_w, x.device), stride, padding,
            **_gemm_kwargs(cfg))
    cols, (n, oh, ow) = im2col(x, (geom.kh, geom.kw), stride, geom.pads)
    wmat = w.reshape(geom.o, -1).t()  # (C*kh*kw, O)
    y2d = qd_gemm(cols, wmat, gen_x, gen_w, **_gemm_kwargs(cfg))
    return y2d.reshape(n, oh, ow, geom.o).permute(0, 3, 1, 2)


def _qd_gemm_precoded_x(
    xc: torch.Tensor,
    x_st: torch.Tensor,
    w2d: torch.Tensor,
    gen_w: torch.Generator | None,
    *,
    fmt: EMFormat,
    gs_fmt: EMFormat,
    k_block: int,
) -> torch.Tensor:
    """:func:`qd_gemm` with ``x`` already coded: uint8 ``xc`` (M, K) against
    the tensor scale ``x_st`` alone (grouping "none", group scale 1).  The
    padding, the weight's quantization and the GEMM are ``qd_gemm``'s, so
    the result is bit-identical to quantizing the fp32 operand again with
    grouping "none" and rounding to nearest."""
    K = xc.shape[1]
    if w2d.shape[0] != K:
        raise ValueError(f"contraction mismatch {tuple(xc.shape)} @ {tuple(w2d.shape)}")
    pk = (-K) % k_block
    xcp = F.pad(xc, (0, pk))  # zero codes decode to 0: exact
    wt = F.pad(w2d.float().t(), (0, pk)).contiguous()  # (N, K + pk)
    wc, wsgT, wst = mls_quantize(wt, fmt, k_block, gs_fmt,
                                 rounding_bytes(wt.shape, gen_w, wt.device), "none")
    ones = torch.ones((1, 1), dtype=torch.float32, device=xc.device)
    return mls_matmul(xcp, ones, x_st, wc.t(), wsgT.t(), wst, fmt, k_block, "none")


def _conv_bwd_impl(x, w, g, key, stride, padding, cfg: QuantConfig):
    geom = conv_geometry(x.shape, w.shape, stride, padding)
    ksize = (geom.kh, geom.kw)
    e2d = g.permute(0, 2, 3, 1).reshape(-1, geom.o).float()
    gen = [rounding_generator(key, cfg, i, x.device) for i in range(2, 6)]
    kwargs = _gemm_kwargs(cfg)
    # G = Cols(qA)^T @ qE: contraction over the N*OH*OW patches (Alg. 1 l.13)
    if cfg.grouping == "none" and gen[0] is None and resolve_conv_impl(geom, cfg) == "implicit":
        # reuse the forward's codes: code the padded input once against the
        # covered tensor scale and gather the codes as bytes
        s_t, xp = covered_tensor_scale(x, geom)
        cols_t = patches_u8(elementwise_codes(xp, s_t, cfg.fmt), geom).t()
        dwmat = _qd_gemm_precoded_x(cols_t, s_t, e2d, gen[1], fmt=cfg.fmt,
                                    gs_fmt=cfg.gs_fmt, k_block=cfg.k_block)
    else:
        cols, _ = im2col(x, ksize, stride, geom.pads)
        dwmat = qd_gemm(cols.t(), e2d, gen[0], gen[1], **kwargs)  # (C*kh*kw, O)
    dw = dwmat.t().reshape(w.shape)
    # dA = qE @ qW^T: contraction over output channels, then col2im + STE
    dcols = qd_gemm(e2d, w.reshape(geom.o, -1).float(), gen[2], gen[3], **kwargs)
    dx = _col2im(dcols, x.shape, ksize, stride, geom.pads, (geom.n, geom.oh, geom.ow))
    return dx, dw


class LowbitConvFused(torch.autograd.Function):
    """NCHW conv whose three training GEMMs run in the MLS quantized domain
    (paper Alg. 1 on real arithmetic).  Each backward GEMM re-quantizes its
    operands from float in its own contraction-aligned group layout (STE)."""

    @staticmethod
    def forward(ctx, x, w, key, stride, padding, cfg):
        ctx.save_for_backward(x, w)
        ctx.conf = (key, stride, padding, cfg)
        return _conv_fwd_impl(x, w, key, stride, padding, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _conv_bwd_impl(x, w, g, *ctx.conf)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None, None


def lowbit_conv_fused(x, w, key, stride, padding, cfg: QuantConfig) -> torch.Tensor:
    """``x`` (N, C, H, W), ``w`` (O, C, kh, kw), ``stride`` a 2-tuple,
    ``padding`` "SAME"/"VALID" or explicit pairs -> fp32 (N, O, OH, OW).
    ``key`` seeds stochastic rounding (``None``: deterministic)."""
    return LowbitConvFused.apply(x, w, key, tuple(stride), padding, cfg)


# ---------------------------------------------------------------------------
# Fused matmul with the same three-GEMM quantized-domain training semantics
# ---------------------------------------------------------------------------
def _mm_fwd_impl(x, w, key, cfg: QuantConfig):
    y2d = qd_gemm(
        x.reshape(-1, x.shape[-1]), w.float(),
        rounding_generator(key, cfg, 0, x.device), rounding_generator(key, cfg, 1, x.device),
        **_gemm_kwargs(cfg),
    )
    return y2d.reshape(*x.shape[:-1], w.shape[1])


def _mm_bwd_impl(x, w, g, key, cfg: QuantConfig):
    x2d = x.reshape(-1, x.shape[-1]).float()
    e2d = g.reshape(-1, g.shape[-1]).float()
    gen = [rounding_generator(key, cfg, i, x.device) for i in range(2, 6)]
    kwargs = _gemm_kwargs(cfg)
    dx2d = qd_gemm(e2d, w.float().t(), gen[0], gen[1], **kwargs)  # dX = qE @ qW^T
    dw = qd_gemm(x2d.t(), e2d, gen[2], gen[3], **kwargs)  # dW = qX^T @ qE
    return dx2d.reshape(x.shape), dw


class LowbitMatmulQD(torch.autograd.Function):
    """``x (..., K) @ w (K, N)`` with all three training GEMMs in the MLS
    quantized domain: the linear-layer analogue of :class:`LowbitConvFused`."""

    @staticmethod
    def forward(ctx, x, w, key, cfg):
        ctx.save_for_backward(x, w)
        ctx.conf = (key, cfg)
        return _mm_fwd_impl(x, w, key, cfg)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _mm_bwd_impl(x, w, g, *ctx.conf)
        return dx.to(x.dtype), dw.to(w.dtype), None, None


def lowbit_matmul_qd(x, w, key, cfg: QuantConfig) -> torch.Tensor:
    return LowbitMatmulQD.apply(x, w, key, cfg)
