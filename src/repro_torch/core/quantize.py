"""Dynamic quantization to the MLS tensor format (paper Alg. 2): grouping,
the ceil-rounded group-scale quantizer, the element quantizer, and on top
of them the whole-tensor quantizer and its fake-quant form:

* :func:`mls_quantize`  -- float tensor -> :class:`MLSTensor` (all levels of
  scaling and the quantized elements, bit-exact fields);
* :func:`fake_quant`    -- float tensor -> float tensor exactly on the MLS
  grid (what the paper simulates on GPU);
* :func:`fake_quant_ste` -- ``fake_quant`` with a straight-through
  gradient (paper Alg. 1 line 16);
* :func:`pack_elements` / :func:`unpack_elements` -- the uint8
  ``sign|exp|man`` codec; :func:`average_relative_error` -- the ARE of the
  paper's Fig. 7 / Table IV.

Grouping is expressed by a :class:`GroupSpec`: a per-axis block size.  Block
size 1 makes the axis a pure group axis (one group per index), block size ==
axis length reduces the whole axis into the group.  The paper's "nc"
grouping of a conv operand ``(N, C, H, W)`` is ``GroupSpec((1, 1, H, W))``;
a matmul operand ``(M, K)`` grouped per row and per 128-wide contraction
block is ``GroupSpec((1, 128))``.

Stochastic rounding takes its U[-1/2, 1/2) offsets ``r`` explicitly: a
float32 tensor of ``x``'s shape, or a ``torch.Generator`` that draws it
(``torch.rand(...) - 0.5`` on the generator's device).  Nothing draws from
a hidden global stream.
"""
from __future__ import annotations

import dataclasses
from collections.abc import Sequence

import torch

from .formats import GS_FMT_DEFAULT, EMFormat, exponent_fraction, pow2

__all__ = [
    "GroupSpec",
    "MLSTensor",
    "average_relative_error",
    "broadcast_groups",
    "fake_quant",
    "fake_quant_ste",
    "group_reduce_max",
    "mls_quantize",
    "normalize_slices",
    "pack_elements",
    "quantize_elements",
    "quantize_grid",
    "quantize_group_scale",
    "unpack_elements",
]


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Per-axis block sizes defining scaling groups.

    ``block[i]`` elements along axis ``i`` share one group (together with the
    blocks of every other axis).  ``None`` means "whole axis in one group".
    """

    block: tuple[int | None, ...]

    def resolve(self, shape: Sequence[int]) -> tuple[int, ...]:
        if len(self.block) != len(shape):
            raise ValueError(f"GroupSpec rank {len(self.block)} != tensor rank {len(shape)}")
        out = []
        for b, d in zip(self.block, shape):
            b = d if b is None else min(b, d)
            if d % b != 0:
                b = d  # one group over the whole axis (coarser, still correct)
            out.append(b)
        return tuple(out)

    def group_shape(self, shape: Sequence[int]) -> tuple[int, ...]:
        return tuple(d // b for d, b in zip(shape, self.resolve(shape)))

    @staticmethod
    def per_tensor(rank: int) -> GroupSpec:
        return GroupSpec((None,) * rank)

    @staticmethod
    def conv_nc(rank: int = 4) -> GroupSpec:
        """The paper's best grouping: one group per (dim0, dim1) pair."""
        return GroupSpec((1, 1) + (None,) * (rank - 2))


def _split_axes(x: torch.Tensor, blocks: tuple[int, ...]) -> torch.Tensor:
    """Reshape (d0, d1, ...) -> (g0, b0, g1, b1, ...)."""
    new_shape = []
    for d, b in zip(x.shape, blocks):
        new_shape.extend((d // b, b))
    return x.reshape(new_shape)


def group_reduce_max(x: torch.Tensor, spec: GroupSpec) -> torch.Tensor:
    blocks = spec.resolve(x.shape)
    xs = _split_axes(x, blocks)
    return torch.amax(xs, dim=tuple(range(1, xs.ndim, 2)))


def broadcast_groups(s: torch.Tensor, spec: GroupSpec, shape: Sequence[int]) -> torch.Tensor:
    """Broadcast a group-shaped array back to the full tensor shape."""
    blocks = spec.resolve(shape)
    expanded = s.reshape(tuple(v for g in s.shape for v in (g, 1)))
    tiled = expanded.expand(tuple(v for g, b in zip(s.shape, blocks) for v in (g, b)))
    return tiled.reshape(tuple(shape))


def quantize_group_scale(
    s_gf: torch.Tensor, gs_fmt: EMFormat
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Quantize group/tensor scale ratios in [0, 1] (paper Alg. 2 l.4-8).

    Fractions are *ceil*-rounded so the quantized scale is >= the true
    ratio, keeping normalized elements <= 1.  Returns ``(s_g, exp_g,
    man_g)`` with ``s_g = (1 + man_g/2^Mg) * 2^-exp_g`` exactly.
    """
    # ratios below 2^-120 mean an (almost) all-zero group; fp32 powers of
    # two end near there, so the exponent is clamped (exact in effect)
    e_min = max(gs_fmt.e_min, -120)
    e, frac = exponent_fraction(s_gf)
    too_small = e < e_min
    e = e.clamp(e_min, 0)
    frac = torch.where(too_small, torch.ones_like(frac), frac)
    man = torch.ceil((frac - 1.0) * 2.0**gs_fmt.m).to(torch.int32)
    overflow = man >= 2**gs_fmt.m  # frac_q == 2: bump the exponent
    man = torch.where(overflow, torch.zeros_like(man), man)
    e = torch.where(overflow, e + 1, e).clamp(e_min, 0)
    s_g = (1.0 + man.to(torch.float32) * 2.0**-gs_fmt.m) * pow2(e)
    return s_g, (-e).to(torch.int32), man


def quantize_grid(x_f: torch.Tensor, fmt: EMFormat, r: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Quantize normalized magnitudes in [0, 1] to the <E,M> grid: the
    on-grid values ``xbar`` of :func:`quantize_elements` alone.

    Paper Alg. 2 lines 9-16: per-element exponent, mantissa rounding
    (stochastic with the U[-1/2, 1/2) tensor ``r``, nearest when ``None``),
    gradual underflow at ``e_min`` and saturation at the top of the grid.
    """
    x_f = x_f.to(torch.float32)
    if fmt.e == 0:  # plain fixed point: uniform grid man/2^M over [0, 1)
        step = 2.0**-fmt.m
        scaled = x_f / step
        q = torch.floor((scaled + r if r is not None else scaled) + 0.5)
        xbar = q.clamp(0.0, 2.0**fmt.m - 1.0) * step
    else:
        e, _ = exponent_fraction(x_f)
        e_eff = e.clamp(fmt.e_min, -1)
        # grid spacing at this exponent level (denormals share e_min's step)
        step = pow2(e_eff - fmt.m)
        scaled = x_f / step
        q = torch.floor((scaled + r if r is not None else scaled) + 0.5)
        # at e_eff == -1 the next exponent does not exist: saturate there;
        # below it, q == 2^(M+1) rounds up into the next exponent level
        qmax = torch.where(
            e_eff == -1,
            torch.full_like(q, 2.0 ** (fmt.m + 1) - 1.0),
            torch.full_like(q, 2.0 ** (fmt.m + 1)),
        )
        xbar = torch.minimum(q.clamp_min(0.0), qmax) * step
    return xbar


def quantize_elements(
    x_f: torch.Tensor, fmt: EMFormat, r: torch.Tensor | None = None
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`quantize_grid` with the exact storage fields: ``(xbar,
    exp_stored, man)``, ``xbar`` exactly on the grid."""
    xbar = quantize_grid(x_f, fmt, r)
    # exact storage fields from the on-grid value
    e2, frac2 = exponent_fraction(xbar)
    is_normal = e2 >= fmt.e_min
    man = torch.where(
        is_normal,
        torch.round((frac2 - 1.0) * 2.0**fmt.m),
        torch.round(xbar * 2.0 ** (fmt.m - fmt.e_min)),
    ).to(torch.int32)
    # stored 0 flags the denormal level; stored s in [1, 2^E - 1] is e = -s
    exp_stored = torch.where(is_normal, -e2, torch.zeros_like(e2)).to(torch.int32)
    return xbar, exp_stored, man


# --------------------------------------------------------------------------
# The MLS tensor and the whole-tensor quantizer
# --------------------------------------------------------------------------
@dataclasses.dataclass
class MLSTensor:
    """A tensor in the multi-level-scaling format (paper Eq. 2):
    ``x = sign * s_t * broadcast(s_g) * xbar``, with ``xbar`` the ``<Ex,Mx>``
    element values, kept dequantized and as exact exponent/mantissa fields."""

    sign: torch.Tensor  # int8, +-1 (0 for zero elements)
    s_t: torch.Tensor  # f32 scalar tensor-wise scale
    s_g: torch.Tensor  # f32, group shape (dequantized group scales)
    exp_g: torch.Tensor  # int32, group shape (stored exponent, >= 0)
    man_g: torch.Tensor  # int32, group shape
    xbar: torch.Tensor  # f32, full shape, on-grid magnitudes in [0, 1)
    exp_x: torch.Tensor  # int32, full shape (stored exponent, >= 0)
    man_x: torch.Tensor  # int32, full shape
    fmt: EMFormat
    gs_fmt: EMFormat
    spec: GroupSpec

    @property
    def shape(self) -> torch.Size:
        return self.xbar.shape

    def dequant(self) -> torch.Tensor:
        scale = self.s_t * broadcast_groups(self.s_g, self.spec, self.shape)
        return self.sign.to(torch.float32) * scale * self.xbar

    def unit_value(self) -> torch.Tensor:
        """The dequantized value with the tensor scale ``s_t`` factored out,
        ``sign * s_g * xbar``: what a low-bit GEMM contracts (paper Sec.
        V-B applies ``s_t`` once to the GEMM's output)."""
        scale = broadcast_groups(self.s_g, self.spec, self.shape)
        return self.sign.to(torch.float32) * scale * self.xbar

    def frac_int(self) -> torch.Tensor:
        """Integer fraction F with ``xbar = F * 2^(e_min - M)``: ``(2^M +
        man) << (2^E - 1 - exp_stored)`` for normals, ``man`` for denormals
        (stored exponent 0); the integer the paper's adder tree multiplies
        (Eq. 7)."""
        top = 2**self.fmt.e - 1
        is_denorm = self.exp_x == 0
        base = torch.where(is_denorm, self.man_x, 2**self.fmt.m + self.man_x)
        shift = torch.where(is_denorm, torch.zeros_like(self.exp_x), top - self.exp_x)
        return base << shift


def _offsets(r: torch.Tensor | torch.Generator | None, x: torch.Tensor) -> torch.Tensor | None:
    """The U[-1/2, 1/2) rounding offsets of ``x``: given, drawn from a
    generator, or ``None`` (round to nearest)."""
    if r is None or isinstance(r, torch.Tensor):
        if r is not None and r.shape != x.shape:
            raise ValueError(f"rounding offsets {tuple(r.shape)} do not match {tuple(x.shape)}")
        return r
    return torch.rand(x.shape, generator=r, device=r.device, dtype=torch.float32) - 0.5


def normalize_slices(
    x: torch.Tensor, spec: GroupSpec, gs_fmt: EMFormat = GS_FMT_DEFAULT,
    tensor_max: torch.Tensor | None = None,
    group_max=None,
) -> tuple[torch.Tensor, ...]:
    """Paper Alg. 2 lines 1-8 over a stack of independent slices ``x[i]``
    (fp32 (n, ...); ``spec`` has block 1 on axis 0): each slice's signs,
    group maxima, its own tensor scale, the quantized group scales, and the
    magnitudes normalized into [0, 1].  Returns ``(sign, s_t (n,), s_g,
    exp_g, man_g, scale, x_f)``, ``scale`` the group scales broadcast to
    ``x``'s shape; a zero slice gets tensor scale 1.  ``tensor_max`` (n,),
    where given, replaces each slice's max |x| as the tensor scale's source
    (the max over a larger operand this slice is part of); ``group_max``,
    where given, maps the group maxima to those of the larger groups each
    slice's groups are part of."""
    n = x.shape[0]
    sign = torch.sign(x).to(torch.int8)
    absx = x.abs()
    s_r = group_reduce_max(absx, spec)  # group maxima
    if group_max is not None:
        s_r = group_max(s_r)
    s_t = (torch.amax(s_r.reshape(n, -1), dim=1) if tensor_max is None
           else tensor_max.reshape(n).to(torch.float32))  # tensor scales
    s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
    s_g, exp_g, man_g = quantize_group_scale(
        s_r / s_t.reshape((n,) + (1,) * (s_r.ndim - 1)), gs_fmt)
    scale = broadcast_groups(s_g, spec, x.shape)
    denom = s_t.reshape((n,) + (1,) * (x.ndim - 1)) * scale
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    x_f = torch.where(denom > 0, absx / safe, torch.zeros_like(absx))
    return sign, s_t, s_g, exp_g, man_g, scale, x_f


def mls_quantize(
    x: torch.Tensor,
    fmt: EMFormat,
    spec: GroupSpec | None = None,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    r: torch.Tensor | torch.Generator | None = None,
    tensor_max: torch.Tensor | None = None,
    group_max=None,
) -> MLSTensor:
    """Full dynamic quantization, paper Alg. 2.  ``spec`` defaults to one
    group over the whole tensor; ``r`` is the stochastic-rounding source
    (``None``: round to nearest); ``tensor_max``, where given, is the max
    |x| the tensor scale is made from in place of ``x``'s own (a shard's:
    the unsharded operand's); ``group_max`` maps the group maxima to those
    of the unsharded operand's groups that ``x``'s are parts of."""
    x = x.to(torch.float32)
    if spec is None:
        spec = GroupSpec.per_tensor(x.ndim)
    sign, s_t, s_g, exp_g, man_g, _, x_f = normalize_slices(
        x[None], GroupSpec((1,) + tuple(spec.block)), gs_fmt,
        None if tensor_max is None else tensor_max.reshape(1), group_max)
    xbar, exp_x, man_x = quantize_elements(x_f[0], fmt, _offsets(r, x))
    return MLSTensor(sign=sign[0], s_t=s_t[0], s_g=s_g[0], exp_g=exp_g[0], man_g=man_g[0],
                     xbar=xbar, exp_x=exp_x, man_x=man_x, fmt=fmt, gs_fmt=gs_fmt, spec=spec)


def fake_quant(
    x: torch.Tensor,
    fmt: EMFormat,
    spec: GroupSpec | None = None,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    r: torch.Tensor | torch.Generator | None = None,
) -> torch.Tensor:
    """Quantize-dequantize: an fp32 tensor exactly on the MLS grid."""
    return mls_quantize(x, fmt, spec, gs_fmt, r).dequant()


class _FakeQuantSTE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fmt, spec, gs_fmt, r):
        return fake_quant(x, fmt, spec, gs_fmt, r)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None, None


def fake_quant_ste(
    x: torch.Tensor,
    fmt: EMFormat,
    spec: GroupSpec | None = None,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    r: torch.Tensor | torch.Generator | None = None,
) -> torch.Tensor:
    """:func:`fake_quant` whose gradient passes straight through (STE)."""
    return _FakeQuantSTE.apply(x, fmt, spec, gs_fmt, r)


# --------------------------------------------------------------------------
# Packed uint8 codec
# --------------------------------------------------------------------------
def pack_elements(t: MLSTensor) -> torch.Tensor:
    """Pack sign/exp/man into uint8 codes ``[sign | exp | man]`` (<= 8 bits)."""
    fmt = t.fmt
    if fmt.element_bits > 8:
        raise ValueError(f"{fmt} does not fit in 8 bits")
    sign_bit = (t.sign.to(torch.int32) < 0).to(torch.int32)
    code = (sign_bit << (fmt.e + fmt.m)) | (t.exp_x << fmt.m) | t.man_x
    return code.to(torch.uint8)


def unpack_elements(code: torch.Tensor, fmt: EMFormat) -> tuple[torch.Tensor, torch.Tensor]:
    """Inverse of :func:`pack_elements`: ``(sign, xbar)`` as float32."""
    code = code.to(torch.int32)
    man = code & (2**fmt.m - 1)
    exp = (code >> fmt.m) & (2**fmt.e - 1)
    sign_bit = code >> (fmt.e + fmt.m)
    top = 2**fmt.e - 1
    is_denorm = exp == 0
    frac = is_denorm.logical_not().to(torch.float32) + man.to(torch.float32) * 2.0**-fmt.m
    mag = frac * pow2(-torch.where(is_denorm, torch.full_like(exp, top), exp))
    sign = 1.0 - 2.0 * sign_bit.to(torch.float32)
    return sign, mag  # zero: man 0, exp 0 (denormal) -> mag 0 whatever its sign


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------
def average_relative_error(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """ARE of the paper's Fig. 7 / Table IV: ``mean|x - q| / mean|x|``."""
    return torch.mean((x - q).abs()) / torch.clamp_min(torch.mean(x.abs()), 1e-30)
