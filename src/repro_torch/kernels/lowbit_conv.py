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

Under tensor parallelism (:class:`~repro_torch.core.lowbit.LinearSplit`)
each operand of a linear's three GEMMs that is one rank's slice of the
unsharded operand is quantized as that slice of the unsharded operand's
quantization: the rounding bytes are the slice of the bytes the unsharded
operand draws from the same stream, and its tensor scale comes from the max
|x| over every slice (K1 in two calls with an all-reduce MAX between them);
the split falls on ``k_block`` boundaries, so its group scales are its own.
A column-parallel linear's forward and weight gradient are then the slices
of the unsharded ones bit for bit, and its data gradient a partial sum over
its groups; a row-parallel linear's the other way round.  A token-split
linear (sequence parallelism: a whole weight on a rank's tokens) holds the
rows of ``x`` and the error that its tokens cover in every batch row (one
piece a row of the flattened operand); its forward and data gradient are
the unsharded rows bit for bit, and its weight gradient contracts its
tokens in whole ``k_block`` groups of the padded contraction, a partial
sum over the group.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from repro_torch.core.formats import EMFormat
from repro_torch.core.lowbit import LinearSplit, QuantConfig, Sharded, rounding_generator

from .implicit_conv import (
    conv_geometry,
    covered_tensor_scale,
    elementwise_codes,
    implicit_conv_forward,
    patches_u8,
    resolve_conv_impl,
)
from . import autotune, launch
from .mls_matmul import mls_matmul, tuned_plan
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
    x_shard: Sharded | None = None,
    w_shard: Sharded | None = None,
) -> torch.Tensor:
    """Quantize ``x (M, K)`` / ``w (K, N)`` dynamically and contract.

    K is zero-padded to a multiple of ``k_block`` (exact: padded codes are
    0, and zeros never raise a group maximum); ragged M/N need no padding,
    the GEMM kernel masks them.  The weight is quantized transposed, so its
    groups run along K, and its codes/scales are handed over as transposed
    views: exactly the GEMM-side compact layout for every grouping.  K3's
    plan resolves through the tile cache on the logical (M, K, N), as the
    JAX package's tiles do (:func:`_gemm_plan`); each quantizer on its own
    operand.  ``x_shard`` / ``w_shard``: the operand is that slice of an
    unsharded one (a dim of ``x2d`` / ``w2d``; module docstring).
    """
    M, K = x2d.shape
    if w2d.shape[0] != K:
        raise ValueError(f"contraction mismatch {tuple(x2d.shape)} @ {tuple(w2d.shape)}")
    plan = _gemm_plan(M, K, w2d.shape[1], fmt, k_block, grouping, **launch.plan_for(x2d))
    pk = (-K) % k_block
    xp = F.pad(x2d.float(), (0, pk)).contiguous()
    wt = F.pad(w2d.float().t(), (0, pk)).contiguous()  # (N, K + pk)
    xc, xsg, xst = _quantize(xp, K, x_shard, gen_x, fmt, k_block, gs_fmt, grouping)
    wc, wsgT, wst = _quantize(wt, K, None if w_shard is None else w_shard.transposed(), gen_w,
                              fmt, k_block, gs_fmt, grouping)
    return mls_matmul(xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, k_block, grouping, plan=plan)


def _quantize(xp: torch.Tensor, K: int, shard: Sharded | None, gen, fmt, k_block: int,
              gs_fmt, grouping: str):
    """K1/K2 on ``qd_gemm``'s padded (rows, K + pad) operand; a slice of a
    sharded one (``shard`` on dim 0, or on dim 1, the contraction, whose
    unsharded width ``full`` pads to ``k_block`` as the unsharded operand
    does; each piece of a slice of several on group boundaries, a ragged
    last group at the dim's end) takes the slice of the unsharded operand's
    bytes and the all-reduced tensor scale."""
    if shard is None:
        return mls_quantize(xp, fmt, k_block, gs_fmt, rounding_bytes(xp.shape, gen, xp.device),
                            grouping)
    if shard.axis(2) == 1:
        shard.check_groups(K, k_block)
        shard = shard.padded(shard.full + (-shard.full) % k_block)
    if gen is None:
        r = rounding_bytes(xp.shape, None, xp.device)
    else:
        r = shard.take(rounding_bytes(shard.full_shape(xp.shape), gen, xp.device),
                       xp.shape[shard.axis(2)]).contiguous()
    import torch.distributed as dist

    return mls_quantize(xp, fmt, k_block, gs_fmt, r, grouping,
                        group=dist.group.WORLD if shard.group is None else shard.group)


def _gemm_plan(M: int, K: int, N: int, fmt: EMFormat, k_block: int, grouping: str,
               device=None, card: str | None = None):
    """K3's plan for ``qd_gemm``'s (M, K) @ (K, N): the tile cache's choice
    for the logical shape on ``device``'s card, or on ``card`` by name (a
    fake operand's, ``launch.plan_for``) (default: ``matmul_plan``'s), on
    K padded to ``k_block``.  A cached choice K3 cannot run raises."""
    config = autotune.resolve_block_config("gemm", (M, K, N), fmt, grouping, k_block=k_block,
                                           device=device, card=card)
    return tuned_plan(config.variant, config.bn, M, N, -(-K // k_block) * k_block, k_block,
                      fmt)


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
    if resolve_conv_impl(geom, cfg, x.device) == "implicit":
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
    plan = _gemm_plan(xc.shape[0], K, w2d.shape[1], fmt, k_block, "none", xc.device)
    pk = (-K) % k_block
    xcp = F.pad(xc, (0, pk))  # zero codes decode to 0: exact
    wt = F.pad(w2d.float().t(), (0, pk)).contiguous()  # (N, K + pk)
    wc, wsgT, wst = mls_quantize(wt, fmt, k_block, gs_fmt,
                                 rounding_bytes(wt.shape, gen_w, wt.device), "none")
    ones = torch.ones((1, 1), dtype=torch.float32, device=xc.device)
    return mls_matmul(xcp, ones, x_st, wc.t(), wsgT.t(), wst, fmt, k_block, "none", plan=plan)


def _conv_bwd_impl(x, w, g, key, stride, padding, cfg: QuantConfig):
    geom = conv_geometry(x.shape, w.shape, stride, padding)
    ksize = (geom.kh, geom.kw)
    e2d = g.permute(0, 2, 3, 1).reshape(-1, geom.o).float()
    gen = [rounding_generator(key, cfg, i, x.device) for i in range(2, 6)]
    kwargs = _gemm_kwargs(cfg)
    # G = Cols(qA)^T @ qE: contraction over the N*OH*OW patches (Alg. 1 l.13)
    if (cfg.grouping == "none" and gen[0] is None
            and resolve_conv_impl(geom, cfg, x.device) == "implicit"):
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
_WHOLE = LinearSplit(None, None, None)


def _2d(shard: Sharded | None, shape) -> Sharded | None:
    """A shard of an operand of ``shape`` (..., n), on its 2-D (rows, n)
    view: of the last dim, that dim; of the token dim (-2; a sequence of
    ``full`` positions), the rows its pieces cover in every leading index,
    ``lead * full`` rows in all."""
    if shard is None:
        return None
    if shard.axis(len(shape)) == len(shape) - 1:
        return dataclasses.replace(shard, dim=1)
    if shard.axis(len(shape)) != len(shape) - 2:
        raise ValueError(f"a shard of dim {shard.dim} of {tuple(shape)}: a linear's operand "
                         f"splits on its last dim or its tokens")
    lead, s = math.prod(shape[:-2]), shard.full
    pieces = tuple((i * s + a, i * s + b) for i in range(lead) for a, b in shard.pieces)
    return Sharded(0, pieces, lead * s, shard.group)


def _t(shard: Sharded | None) -> Sharded | None:
    return None if shard is None else shard.transposed()


def _mm_fwd_impl(x, w, key, cfg: QuantConfig, split: LinearSplit = _WHOLE):
    y2d = qd_gemm(
        x.reshape(-1, x.shape[-1]), w.float(),
        rounding_generator(key, cfg, 0, x.device), rounding_generator(key, cfg, 1, x.device),
        **_gemm_kwargs(cfg), x_shard=_2d(split.x, x.shape), w_shard=split.w,
    )
    return y2d.reshape(*x.shape[:-1], w.shape[1])


def _mm_bwd_impl(x, w, g, key, cfg: QuantConfig, split: LinearSplit = _WHOLE):
    x2d = x.reshape(-1, x.shape[-1]).float()
    e2d = g.reshape(-1, g.shape[-1]).float()
    gen = [rounding_generator(key, cfg, i, x.device) for i in range(2, 6)]
    kwargs = _gemm_kwargs(cfg)
    e_sh = _2d(split.e, g.shape)
    # dX = qE @ qW^T
    dx2d = qd_gemm(e2d, w.float().t(), gen[0], gen[1], **kwargs, x_shard=e_sh,
                   w_shard=_t(split.w))
    # dW = qX^T @ qE
    dw = qd_gemm(x2d.t(), e2d, gen[2], gen[3], **kwargs, x_shard=_t(_2d(split.x, x.shape)),
                 w_shard=e_sh)
    return dx2d.reshape(x.shape), dw


class LowbitMatmulQD(torch.autograd.Function):
    """``x (..., K) @ w (K, N)`` with all three training GEMMs in the MLS
    quantized domain: the linear-layer analogue of :class:`LowbitConvFused`.
    With a :class:`~repro_torch.core.lowbit.LinearSplit`, one rank's part of
    a tensor-parallel linear (its outputs, or partial sums where the split
    contracts)."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, split):
        ctx.save_for_backward(x, w)
        ctx.conf = (key, cfg, split or _WHOLE)
        return _mm_fwd_impl(x, w, key, cfg, split or _WHOLE)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx, dw = _mm_bwd_impl(x, w, g, *ctx.conf)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def lowbit_matmul_qd(x, w, key, cfg: QuantConfig, split: LinearSplit | None = None
                     ) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` -> fp32 on K1 and K3 (:class:`LowbitMatmulQD`);
    ``split``: this rank's shards of a tensor-parallel linear."""
    return LowbitMatmulQD.apply(x, w, key, cfg, split)
