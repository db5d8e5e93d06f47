"""Layer ops of the port: conv, linear, batchnorm and the residual add;
for the LM families also the norms, rotary embeddings and grouped-query
attention, and the :class:`Linear` module.

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

The LM ops follow the JAX package's ``models/nn.py`` step by step,
dtypes included: norms compute in fp32 and cast back to the input's
dtype; attention computes its scores, softmax and weighted sum in fp32
as plain PyTorch ops (the JAX package runs them outside any Pallas
kernel) and masks with ``-1e30``, so a row with no valid key averages V.
"""
from __future__ import annotations

import contextvars
import dataclasses
import math

import torch
from torch import nn

from repro_torch.core.lowbit import (
    LinearSplit,
    QuantConfig,
    conv2d_fp32,
    lowbit_conv,
    lowbit_matmul,
)
from repro_torch.kernels.lowbit_conv import lowbit_conv_fused, lowbit_matmul_qd
from repro_torch.parallel.fsdp_wire import WireShard

__all__ = [
    "Linear",
    "OpTrace",
    "apply_rope",
    "batchnorm",
    "conv2d",
    "ew_add",
    "gqa_attention",
    "layernorm",
    "linear",
    "rmsnorm",
    "rope_angles",
    "trunc_normal",
]

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


def linear(x, w, b=None, qcfg: QuantConfig | None = None, key=None,
           wire: int | WireShard | None = None,
           split: LinearSplit | None = None) -> torch.Tensor:
    """``x (..., d_in) @ w (d_in, d_out)`` -> fp32; the bias is added in
    fp32.  Unquantized, ``w`` is first rounded to ``x``'s dtype and the
    products summed in fp32, as the JAX package's ``dot_general`` with
    ``preferred_element_type=float32`` does (exact products of bf16
    operands; TF32 must be off on the card).  ``wire``: the weight dim
    that FSDP shards (0 for an in-projection, 1 for an out-projection),
    where the fake-quant backend pins the weight's gather
    (``QuantConfig.wire_fsdp_dim``); the quantized backend moves codes
    already and ignores it, as the JAX package's does.  ``split``: ``x``,
    ``w`` (and the error) are this rank's shards of a tensor-parallel
    linear, quantized as slices of the unsharded operands (the result is
    this rank's outputs or partial sums; ``parallel.tensor.TPLinear``).
    A :class:`~repro_torch.parallel.fsdp_wire.WireShard` as ``wire``: the
    weight is held sharded over the data axis and ``w`` is its gather
    proxy; the fake-quant backend gathers it as packed codes, and any
    other path raises."""
    _trace("fc", d_in=w.shape[0], d_out=w.shape[1], rows=x.numel() // x.shape[-1],
           quantized=_quantized(qcfg))
    packed = isinstance(wire, WireShard)
    if packed and not (_quantized(qcfg) and qcfg.backend == "fake_quant"):
        raise ValueError("a weight held sharded over the data axis is gathered as packed "
                         "codes, on the fake-quant backend only")
    if _quantized(qcfg):
        tp = {} if split is None else {"split": split}
        if packed:
            y = lowbit_matmul(x, w, key, qcfg, wire=wire, **tp)
        elif qcfg.backend == "quantized":
            y = lowbit_matmul_qd(x, w.float(), key, qcfg, **tp)
        else:
            if wire is not None and qcfg.wire_fsdp_dim != wire:
                qcfg = dataclasses.replace(qcfg, wire_fsdp_dim=wire)
            y = lowbit_matmul(x, w.float(), key, qcfg, **tp)
    else:
        y = x.float() @ w.to(x.dtype).float()
    return y if b is None else y + b.float()


def trunc_normal(shape, std: float = 0.02, generator: torch.Generator | None = None,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """fp32 normal draws truncated to [-2, 2], times ``std``: the JAX
    package's ``truncated_normal(key, -2, 2) * std`` (not its stream)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t.mul_(std)


class Linear(nn.Module):
    """A linear layer in the JAX package's ``init_linear`` layout: weight
    ``w`` (d_in, d_out), optional bias ``b`` (d_out,), fp32.  Under tensor
    parallelism ``tp`` (a ``parallel.tensor.TPLinear``) says how this rank
    holds and runs it; None: whole.  Under sequence parallelism the call's
    ``seq`` (a ``parallel.tensor.SeqShard``) says that its output lies on
    this rank's tokens: a row-parallel linear reduce-scatters its sums to
    them, and a whole one runs on them (its input the rank's tokens, its
    quantized operands token slices, ``SeqShard.split``).  Under FSDP with
    ``packed_wire``, ``wire`` (a ``parallel.fsdp_wire.WireShard``) says that
    ``w`` is held sharded over the data axis and gathered as packed codes
    at each call; None: FSDP2 gathers it, or it is whole."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out)) if bias else None
        self.tp = None
        self.wire = None

    @torch.no_grad()
    def init_(self, generator: torch.Generator, std: float | None = None) -> None:
        """``init_linear``'s draws: truncated normal times ``std``, or
        Xavier-uniform when ``std`` is None; a zero bias."""
        d_in, d_out = self.w.shape
        if std is None:
            lim = math.sqrt(6.0 / (d_in + d_out))
            self.w.uniform_(-lim, lim, generator=generator)
        else:
            self.w.copy_(trunc_normal(self.w.shape, std, generator, self.w.device))
        if self.b is not None:
            self.b.zero_()

    def forward(self, x, qcfg: QuantConfig | None = None, key=None,
                wire: int | None = None, seq=None) -> torch.Tensor:
        w = self.w
        if self.wire is not None:
            wire, w = self.wire.at(wire), self.wire.proxy()
        if self.tp is not None:
            return self.tp(linear, x, w, self.b, qcfg, key, wire, seq)
        return linear(x, w, self.b, qcfg, key, wire, None if seq is None else seq.split())


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


# ---------------------------------------------------------------------------
# LM layers: norms, rotary embeddings, grouped-query attention
# ---------------------------------------------------------------------------
def layernorm(x, gamma, beta, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 (biased variance), cast back
    to ``x``'s dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mu).square().mean(dim=-1, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * gamma + beta).to(x.dtype)


def rmsnorm(x, gamma, eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis in fp32, cast back to ``x``'s dtype."""
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    return (y * gamma).to(x.dtype)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float = 10000.0,
                rotary_dim: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sin, cos)`` of shape ``positions.shape + (rotary_dim / 2,)``, fp32."""
    rd = rotary_dim or head_dim
    exponent = torch.arange(0, rd, 2, dtype=torch.float32, device=positions.device) / rd
    inv = 1.0 / (theta ** exponent)
    ang = positions[..., None].float() * inv
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor,
               rotary_dim: int | None = None) -> torch.Tensor:
    """Rotate interleaved pairs (``0::2``, ``1::2``) of the first
    ``rotary_dim`` dims of ``x`` (B, S, H, D), the rest passing through
    (GLM's half-rotary when ``rotary_dim < D``).  ``sin``/``cos``: (B, S,
    rotary_dim / 2).  Promotes as JAX does (bf16 x with fp32 angles ->
    fp32)."""
    d = x.shape[-1]
    rd = rotary_dim or d
    xr, xp = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape)
    return torch.cat([out, xp.to(out.dtype)], dim=-1) if rd < d else out


def _gqa_attention_block(q, k, v, causal, q_offset, window, kv_len):
    """q (B, Sq, Hkv, G, D) against k, v (B, Sk, Hkv, D) -> fp32 (B, Sq,
    Hkv, G, D)."""
    _, sq, _, _, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / torch.tensor(float(d), dtype=torch.float32).sqrt()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", q.float(), k.float()) * scale.to(q.device)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & (kpos > qpos - window)
    if kv_len is not None:
        mask = mask & (kpos < kv_len)
    logits = torch.where(mask, logits, torch.tensor(-1e30, dtype=torch.float32,
                                                     device=q.device))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())


def gqa_attention(
    q: torch.Tensor,  # (B, Sq, Hq, D)
    k: torch.Tensor,  # (B, Sk, Hkv, D)
    v: torch.Tensor,  # (B, Sk, Hkv, D)
    causal: bool = True,
    q_offset: int = 0,  # position of q[0] within the kv sequence
    window: int | None = None,  # sliding-window size (None = full)
    kv_len: int | None = None,  # number of valid cache slots
    q_chunk: int | None = None,  # memory-efficient query chunking
    kv_map: tuple[int, ...] | None = None,  # the kv head each query head reads
) -> torch.Tensor:
    """Grouped-query attention -> fp32 (B, Sq, Hq, D).  With ``q_chunk``
    (when it divides Sq and Sq exceeds it) the queries run in blocks, each
    with an exact softmax over the full key range, so the score matrix
    never exceeds (B, H, q_chunk, Sk).  ``kv_map``: query head ``h`` reads
    kv head ``kv_map[h]`` (a rank's irregular share of the heads under
    tensor parallelism): k and v are gathered to the query heads; None:
    each kv head serves ``Hq / Hkv`` consecutive query heads."""
    b, sq, hq, d = q.shape
    if kv_map is not None:
        idx = torch.tensor(kv_map, dtype=torch.long, device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    qg = q.reshape(b, sq, hkv, hq // hkv, d)
    if q_chunk is None or sq <= q_chunk or sq % q_chunk:
        return _gqa_attention_block(qg, k, v, causal, q_offset, window, kv_len).reshape(
            b, sq, hq, d)
    out = [_gqa_attention_block(qg[:, i:i + q_chunk], k, v, causal, q_offset + i, window,
                                kv_len) for i in range(0, sq, q_chunk)]
    return torch.cat(out, dim=1).reshape(b, sq, hq, d)
