"""Low-bit training configuration and the fake-quant training ops (paper
Alg. 1 / Sec. V-B).

:class:`QuantConfig` says how a layer quantizes the three operands of its
conv/matmul (weights, activations, back-propagated errors), and with which
arithmetic (``backend``).  Stochastic rounding (paper Eq. 5) draws from a
seeded ``torch.Generator`` per (step, site tag, operand index):
:func:`fold_in` derives the seeds, :func:`rounding_generator` builds the
generator.

:func:`lowbit_matmul` / :func:`lowbit_conv` are the ``"fake_quant"``
backend: they quantize **both operands** to the MLS format on the forward
pass and the **back-propagated error** once before the two backward
GEMMs/convs (streams 0, 1 and 2 of the site), and run the GEMMs/convs
themselves in fp32 on the dequantized (unit-scaled) values, as the JAX
package does outside any Pallas kernel; :func:`lowbit_matmul_stack` is
:func:`lowbit_matmul` over a stack of independent GEMMs (the MoE experts,
which the JAX package runs under ``jax.vmap``), each with its own scales:

    forward : Z  = Conv(qW, qA)                        (l.4)
    backward: G  = Conv(qE, qA)      -> weight grad    (l.13)
              dA = Conv(qE, qW), STE -> input grad     (l.15-16)

The ``"quantized"`` backend (the port's main path) runs the same three
GEMMs in the quantized domain on the CUDA kernels
(:mod:`repro_torch.kernels.lowbit_conv`).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .formats import EMFormat, FMT_IMAGENET, GS_FMT_DEFAULT, accumulation_bits
from .quantize import GroupSpec, mls_quantize, normalize_slices, quantize_grid

__all__ = [
    "BACKENDS",
    "GROUPINGS",
    "QuantConfig",
    "fold_in",
    "lowbit_conv",
    "lowbit_matmul",
    "lowbit_matmul_stack",
    "quantize_operand",
    "quantize_stack",
    "rounding_generator",
]

GROUPINGS = ("nc", "c", "n", "none")  # scaling-group layouts, paper Table IV
BACKENDS = ("quantized", "fake_quant")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """How a layer quantizes its three conv/matmul operands."""

    fmt: EMFormat = FMT_IMAGENET  # <Ex,Mx> for W/A/E (paper uses one format)
    gs_fmt: EMFormat = GS_FMT_DEFAULT  # <Eg,Mg> group-scale format
    grouping: str = "nc"  # "nc" | "c" | "n" | "none"  (paper Table IV)
    k_block: int = 128  # contraction block of a scaling group
    stochastic: bool = True  # stochastic rounding (False -> nearest)
    enabled: bool = True
    # Arithmetic of the three training GEMMs: "quantized" runs them in the
    # MLS quantized domain (mls_quantize -> mls_matmul over im2col, the CUDA
    # kernels); "fake_quant" quantizes and dequantizes the operands and runs
    # fp32 convs/matmuls on them (the JAX package's default backend, and
    # the paper's GPU simulation).
    backend: str = "quantized"
    # Forward-conv lowering: "im2col", "implicit" (the implicit-GEMM kernel;
    # needs k_block = cb*kh*kw with cb | C) or "auto" (implicit where legal,
    # else im2col).  The choice never changes numerics.
    conv_impl: str = "auto"

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(
                f"QuantConfig.backend must be 'quantized' or 'fake_quant', "
                f"got {self.backend!r}"
            )
        if self.grouping not in GROUPINGS:
            raise ValueError(
                f"QuantConfig.grouping must be one of 'nc'/'c'/'n'/'none', "
                f"got {self.grouping!r}"
            )
        if self.conv_impl not in ("auto", "im2col", "implicit"):
            raise ValueError(
                f"QuantConfig.conv_impl must be 'auto', 'im2col' or 'implicit', "
                f"got {self.conv_impl!r}"
            )
        # A scaling group sums k_block products of product_bits-wide
        # integers; the sum must stay exact (below 2^24) in fp32.
        acc = accumulation_bits(self.fmt, self.k_block)
        if acc >= 24:
            raise ValueError(
                f"QuantConfig: accumulating k_block={self.k_block} products "
                f"of {self.fmt} values spans {acc} integer bits "
                f"(product_bits={self.fmt.product_bits} + "
                f"ceil(log2(k_block))) >= 24, so fp32 accumulation is no "
                f"longer exact integer arithmetic. Reduce k_block or use a "
                f"narrower <E,M> format."
            )


    def _aligned_kb(self, k: int) -> int:
        return min(self.k_block, k)

    def matmul_specs(self, x_shape, w_shape) -> tuple[GroupSpec, GroupSpec]:
        """Group specs for ``x @ w`` with x: (..., K), w: (K, N): the
        contraction axis plays the input channel.  "nc" gives one scale per
        (row, k-block) of x and per (k-block, column) of w."""
        kb = self._aligned_kb(x_shape[-1])
        if self.grouping == "none":
            return GroupSpec.per_tensor(len(x_shape)), GroupSpec.per_tensor(2)
        if self.grouping == "c":  # contraction blocks only
            return (GroupSpec((None,) * (len(x_shape) - 1) + (kb,)), GroupSpec((kb, None)))
        if self.grouping == "n":  # row/column only
            return (GroupSpec((1,) * (len(x_shape) - 1) + (None,)), GroupSpec((None, kb)))
        return (GroupSpec((1,) * (len(x_shape) - 1) + (kb,)), GroupSpec((kb, 1)))

    def conv_specs(self) -> tuple[GroupSpec, GroupSpec]:
        """Group specs for NCHW activations / OIHW weights (paper Sec. IV-B)."""
        if self.grouping == "none":
            return GroupSpec.per_tensor(4), GroupSpec.per_tensor(4)
        if self.grouping == "c":
            return GroupSpec((None, 1, None, None)), GroupSpec((None, 1, None, None))
        if self.grouping == "n":
            return GroupSpec((1, None, None, None)), GroupSpec((1, None, None, None))
        return GroupSpec.conv_nc(), GroupSpec.conv_nc()


_MASK64 = (1 << 64) - 1


def fold_in(key: int | None, data: int) -> int | None:
    """Derive an independent 63-bit stream seed from ``key`` and ``data``
    (splitmix64 of the pair); ``None`` stays ``None`` (no randomness)."""
    if key is None:
        return None
    z = (key * 0x9E3779B97F4A7C15 + data + 1) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) >> 1


def rounding_generator(
    key: int | None, cfg: QuantConfig, idx: int, device: torch.device | str
) -> torch.Generator | None:
    """The rounding stream of GEMM operand ``idx`` (0-5) at one site: a
    generator on ``device`` seeded from ``fold_in(key, idx)``, or ``None``
    when rounding is deterministic."""
    if key is None or not cfg.stochastic:
        return None
    g = torch.Generator(device=device)
    g.manual_seed(fold_in(key, idx))
    return g


# ---------------------------------------------------------------------------
# The fake-quant backend
# ---------------------------------------------------------------------------
def _source(key: int | None, cfg: QuantConfig, idx: int, device, r) -> (
        torch.Tensor | torch.Generator | None):
    """Operand ``idx``'s rounding source: ``r[idx]`` when offsets are given
    (``r``: a tuple of U[-1/2, 1/2) tensors, one per operand), else its
    stream's generator (``None``: nearest)."""
    if r is not None:
        return r[idx]
    return rounding_generator(key, cfg, idx, device)


def quantize_operand(x: torch.Tensor, cfg: QuantConfig, spec: GroupSpec, key: int | None,
                     idx: int, r=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize -> ``(unit-scaled values, fp32 tensor scale)``: the tensor
    scale is factored out of the GEMM (paper Sec. V-B).  ``idx`` is the
    operand's rounding stream at the site (0: activation, 1: weight, 2:
    error); ``r`` gives the offsets instead (see :func:`lowbit_matmul`)."""
    if not cfg.enabled:
        return x.to(torch.float32), torch.ones((), dtype=torch.float32, device=x.device)
    t = mls_quantize(x, cfg.fmt, spec, cfg.gs_fmt, _source(key, cfg, idx, x.device, r))
    return t.unit_value(), t.s_t


def _error_spec(cfg: QuantConfig, g: torch.Tensor) -> GroupSpec:
    """The matmul error's groups: per (row, k-block) for "nc"/"c", else one."""
    if cfg.grouping in ("nc", "c"):
        return GroupSpec((1,) * (g.ndim - 1) + (min(cfg.k_block, g.shape[-1]),))
    return GroupSpec.per_tensor(g.ndim)


class LowbitMatmul(torch.autograd.Function):
    """``x (..., K) @ w (K, N)`` with MLS fake-quantized operands and error."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, r):
        sx, sw = cfg.matmul_specs(x.shape, w.shape)
        qx, stx = quantize_operand(x, cfg, sx, key, 0, r)
        qw, stw = quantize_operand(w, cfg, sw, key, 1, r)
        ctx.save_for_backward(qx, stx, qw, stw)
        ctx.conf = (key, cfg, r, x.dtype, w.dtype)
        return torch.matmul(qx, qw) * (stx * stw)

    @staticmethod
    def backward(ctx, g):
        qx, stx, qw, stw = ctx.saved_tensors
        key, cfg, r, x_dtype, w_dtype = ctx.conf
        ge, ste = quantize_operand(g.to(torch.float32), cfg, _error_spec(cfg, g), key, 2, r)
        dx = torch.matmul(ge, qw.t()) * (ste * stw)  # paper l.15: qE @ qW^T
        dw = torch.matmul(qx.reshape(-1, qx.shape[-1]).t(),
                          ge.reshape(-1, ge.shape[-1])) * (ste * stx)  # l.13: qX^T @ qE
        return dx.to(x_dtype), dw.to(w_dtype), None, None, None


def lowbit_matmul(x: torch.Tensor, w: torch.Tensor, key: int | None,
                  cfg: QuantConfig, r=None) -> torch.Tensor:
    """``x @ w`` with MLS-quantized operands; x: (..., K), w: (K, N).
    ``r``, where given, is ``(r_x, r_w, r_e)``: the rounding offsets of the
    activation, the weight and the error, each of its operand's shape, in
    place of the streams of ``key``."""
    return LowbitMatmul.apply(x, w, key, cfg, r)


# Elements one pass of quantize_stack codes at a time (whole experts): it
# bounds the quantizer's fp32 temporaries at a few GiB on an expert stack
# of 671 M elements (llama4-scout's w_up: 16 x 5120 x 8192).
STACK_CHUNK = 1 << 27


def quantize_stack(x: torch.Tensor, cfg: QuantConfig, spec: GroupSpec,
                   r: torch.Tensor | torch.Generator | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Each slice ``x[i]`` of a stack quantized with its own tensor and
    group scales (``spec`` groups one slice): ``(unit values (E, ...), fp32
    tensor scales (E,))``, bit for bit ``quantize_operand`` of each slice on
    the offsets ``r[i]``.  ``r``: offsets of ``x``'s shape, a generator that
    draws them slice group by slice group, or ``None`` (nearest).  The
    slices are coded STACK_CHUNK elements at a time, whole slices each."""
    n = x.shape[0]
    if isinstance(r, torch.Tensor) and r.shape != x.shape:
        raise ValueError(f"rounding offsets {tuple(r.shape)} do not match {tuple(x.shape)}")
    if not cfg.enabled:
        return x.to(torch.float32), torch.ones(n, dtype=torch.float32, device=x.device)
    full = GroupSpec((1,) + tuple(spec.block))
    unit = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    s_t = torch.empty(n, dtype=torch.float32, device=x.device)
    per = max(1, STACK_CHUNK // max(1, x[0].numel()))
    for lo in range(0, n, per):
        xs = x[lo:lo + per].to(torch.float32)
        if isinstance(r, torch.Generator):
            rs = torch.rand(xs.shape, generator=r, device=r.device, dtype=torch.float32) - 0.5
        else:
            rs = None if r is None else r[lo:lo + per]
        sign, s_t[lo:lo + per], _, _, _, scale, x_f = normalize_slices(xs, full, cfg.gs_fmt)
        unit[lo:lo + per] = sign.to(torch.float32) * scale * quantize_grid(x_f, cfg.fmt, rs)
    return unit, s_t


# torch.profiler spans of the stacked GEMM's forward and backward (what a
# trace reads as the MoE experts' fake-quant time)
STACK_SPANS = ("lowbit_matmul_stack", "lowbit_matmul_stack.backward")


class LowbitMatmulStack(torch.autograd.Function):
    """``x (E, R, K) @ w (E, K, N)``: E independent :class:`LowbitMatmul`,
    each operand of the stack quantized at once (:func:`quantize_stack`)."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, r):
        with torch.profiler.record_function(STACK_SPANS[0]):
            sx, sw = cfg.matmul_specs(x.shape[1:], w.shape[1:])
            qx, stx = quantize_stack(x, cfg, sx, _source(key, cfg, 0, x.device, r))
            qw, stw = quantize_stack(w, cfg, sw, _source(key, cfg, 1, x.device, r))
            ctx.save_for_backward(qx, stx, qw, stw)
            ctx.conf = (key, cfg, r, x.dtype, w.dtype)
            return torch.matmul(qx, qw) * (stx * stw)[:, None, None]

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(STACK_SPANS[1]):
            qx, stx, qw, stw = ctx.saved_tensors
            key, cfg, r, x_dtype, w_dtype = ctx.conf
            ge, ste = quantize_stack(g.to(torch.float32), cfg, _error_spec(cfg, g[0]),
                                     _source(key, cfg, 2, g.device, r))
            dx = torch.matmul(ge, qw.transpose(1, 2)) * (ste * stw)[:, None, None]
            dw = torch.matmul(qx.transpose(1, 2), ge) * (ste * stx)[:, None, None]
            return dx.to(x_dtype), dw.to(w_dtype), None, None, None


def lowbit_matmul_stack(x: torch.Tensor, w: torch.Tensor, key: int | None,
                        cfg: QuantConfig, r=None) -> torch.Tensor:
    """``x (E, R, K) @ w (E, K, N)`` -> fp32 (E, R, N): for each ``e``,
    :func:`lowbit_matmul` of ``x[e]`` and ``w[e]`` (its own tensor and group
    scales), in some 40 operations per operand for the whole stack.  The
    rounding offsets of each operand come from one stream of ``key`` for
    the whole stack, or from ``r = (r_x, r_w, r_e)`` of the stacked shapes."""
    return LowbitMatmulStack.apply(x, w, key, cfg, r)


def conv_pads(hw, ksize, stride, padding) -> tuple[tuple[int, int], tuple[int, int]]:
    """``((ph_lo, ph_hi), (pw_lo, pw_hi))`` of "SAME"/"VALID" or explicit
    pairs, by the rule of ``lax.padtype_to_pads``: "SAME" gives ``out =
    ceil(in / stride)`` with the odd pad at the high end."""
    if isinstance(padding, str):
        if padding == "VALID":
            return (0, 0), (0, 0)
        if padding != "SAME":
            raise ValueError(f"unknown padding {padding!r}")
        pads = []
        for d, k, s in zip(hw, ksize, stride):
            total = max((-(-d // s) - 1) * s + k - d, 0)
            pads.append((total // 2, total - total // 2))
        return tuple(pads)
    (a, b), (c, d) = padding
    return (int(a), int(b)), (int(c), int(d))


def conv2d_fp32(x: torch.Tensor, w: torch.Tensor, stride, padding) -> torch.Tensor:
    """NCHW/OIHW fp32 conv with JAX's padding rule (``F.conv2d`` pads only
    symmetrically, so the pads are applied with ``F.pad``)."""
    s = (stride, stride) if isinstance(stride, int) else tuple(stride)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads(x.shape[2:], w.shape[2:], s, padding)
    return F.conv2d(F.pad(x.float(), (pw_lo, pw_hi, ph_lo, ph_hi)), w.float(), stride=s)


class LowbitConv(torch.autograd.Function):
    """NCHW conv with MLS fake-quantized W/A/E (paper Alg. 1): the error is
    quantized once and used by both gradients, which are the fp32 conv's
    own transposes evaluated at the quantized operands."""

    @staticmethod
    def forward(ctx, x, w, key, stride, padding, cfg):
        sa, sw = cfg.conv_specs()
        qx, stx = quantize_operand(x, cfg, sa, key, 0)
        qw, stw = quantize_operand(w, cfg, sw, key, 1)
        ctx.save_for_backward(qx, stx, qw, stw)
        ctx.conf = (key, stride, padding, cfg, x.dtype, w.dtype)
        return conv2d_fp32(qx, qw, stride, padding) * (stx * stw)

    @staticmethod
    def backward(ctx, g):
        qx, stx, qw, stw = ctx.saved_tensors
        key, stride, padding, cfg, x_dtype, w_dtype = ctx.conf
        ge, ste = quantize_operand(g.to(torch.float32), cfg, cfg.conv_specs()[0], key, 2)
        with torch.enable_grad():
            a, b = qx.detach().requires_grad_(), qw.detach().requires_grad_()
            dx, dw = torch.autograd.grad(conv2d_fp32(a, b, stride, padding), (a, b), ge)
        return ((dx * (ste * stw)).to(x_dtype), (dw * (ste * stx)).to(w_dtype),
                None, None, None, None)


def lowbit_conv(x: torch.Tensor, w: torch.Tensor, key: int | None, stride, padding,
                cfg: QuantConfig) -> torch.Tensor:
    """NCHW conv with MLS-quantized W/A/E; ``key`` seeds the site's
    stochastic rounding (``None``: round to nearest)."""
    return LowbitConv.apply(x, w, key, stride, padding, cfg)
