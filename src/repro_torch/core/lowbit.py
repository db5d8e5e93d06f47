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

Under tensor parallelism (:mod:`repro_torch.parallel.tensor`) a GEMM
operand may be one rank's slice of the unsharded operand
(:class:`Sharded`; a linear's three, :class:`LinearSplit`).  It is then
quantized as the slice of the unsharded operand's quantization: its
tensor scale is the max over every slice (an all-reduce MAX over the
slices' ranks), its groups are its own (the split falls on group
boundaries; on the fake-quant backend a dim that is one group, as a
ragged dim is, shares each group's max over the ranks the same way) and
its rounding offsets are the slice of the offsets the unsharded operand
draws from the same stream.  A slice may be several pieces of the dim,
concatenated (:class:`Sharded`'s ``pieces``).

Under FSDP with ``packed_wire`` (:mod:`repro_torch.parallel.fsdp_wire`) a
weight is also one data rank's slice along its wire dim (a second
:class:`Sharded`, the ``wire_shard`` of :func:`quantize_operand`): it is
quantized as the slice of the unsharded weight the same way, and its
packed codes and compact group scales are gathered over the data group
(:meth:`Sharded.gather`), unpacked and broadcast: the unit values of the
unsharded weight, bit for bit, moved at 1 B an element.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

from .formats import EMFormat, FMT_IMAGENET, GS_FMT_DEFAULT, accumulation_bits
from .quantize import (
    GroupSpec,
    broadcast_groups,
    mls_quantize,
    normalize_slices,
    pack_elements,
    quantize_grid,
    unpack_elements,
)

__all__ = [
    "BACKENDS",
    "GROUPINGS",
    "LinearSplit",
    "QuantConfig",
    "Sharded",
    "fold_in",
    "lowbit_conv",
    "lowbit_matmul",
    "lowbit_matmul_stack",
    "quantize_operand",
    "quantize_stack",
    "rounding_generator",
    "stack_offsets",
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
    # Route the fake-quant WEIGHT through its packed uint8 codes and compact
    # group scales, each pinned to the FSDP shard axis (parallel.wire_pin;
    # under FSDP2, parallel.fsdp_wire gathers them over the data axis): an
    # exact round trip, so the numbers do not move.
    packed_wire: bool = False
    # Which weight dim is FSDP-sharded (0 for in-projections, 1 for
    # out-projections); None disables the pinning.  Set per call site by the
    # layers (models.nn.linear(..., wire=...)).
    wire_fsdp_dim: int | None = None
    # The contraction axis of a GEMM weight is FSDP-sharded this many ways in
    # the JAX package's production mesh, and a fake-quant matmul's scaling
    # groups are narrowed to align with those shards (_aligned_kb): this
    # changes the groups, and so the numbers, on one device as well.  1: no
    # alignment; ModelConfig.qcfg sets 16, as the JAX package does.  The
    # quantized backend keeps k_block whatever this says.
    shard_ways: int = 1

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
        """The matmul's group width along a contraction of ``k``: the widest
        of ``(k_block, 64, 32, 16)`` that divides ``k`` into a multiple of
        ``shard_ways`` groups, else ``min(k_block, k)``."""
        if self.shard_ways > 1:
            for kb in (self.k_block, 64, 32, 16):
                if k % kb == 0 and (k // kb) % self.shard_ways == 0:
                    return kb
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
# Operands sharded over ranks (tensor parallelism)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sharded:
    """A GEMM operand that is one rank's slice along ``dim`` of an operand
    whose ``dim`` has ``full`` elements: the ordered ``pieces`` ``[a, b)``
    of that dim, concatenated (one piece where the rank holds a contiguous
    slice); the other slices lie on the other ranks of ``group`` (a
    ``torch.distributed`` process group; None: the default group)."""

    dim: int
    pieces: tuple[tuple[int, int], ...]
    full: int
    group: Any = dataclasses.field(default=None, compare=False)

    def axis(self, ndim: int) -> int:
        return self.dim % ndim

    def spans(self, size: int) -> tuple[tuple[int, int], ...]:
        """The pieces, checked to hold a slice of ``size`` elements."""
        if sum(b - a for a, b in self.pieces) != size:
            raise ValueError(f"the pieces {self.pieces} do not hold {size} elements")
        return self.pieces

    def full_shape(self, shape) -> tuple[int, ...]:
        shape = list(shape)
        shape[self.axis(len(shape))] = self.full
        return tuple(shape)

    def take(self, full: torch.Tensor, size: int) -> torch.Tensor:
        """This rank's ``size`` elements of an unsharded tensor along ``dim``:
        its pieces, concatenated."""
        ax = self.axis(full.ndim)
        parts = [full.narrow(ax, a, b - a) for a, b in self.spans(size)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=ax)

    def transposed(self) -> Sharded:
        """The same slice of the 2-D operand transposed."""
        return dataclasses.replace(self, dim=1 - self.axis(2))

    def padded(self, full: int) -> Sharded:
        """The slice of the operand padded (at its end) to ``full``: a piece
        that ends at the old end runs to the new one."""
        pieces = tuple((a, full if b == self.full else b) for a, b in self.pieces)
        return dataclasses.replace(self, full=full, pieces=pieces)

    def check_groups(self, size: int, block: int) -> None:
        """Each piece of a slice of ``size`` falls on ``block``-wide group
        boundaries of the unsharded dim; a ragged piece (the dim's ragged
        last group) ends the dim."""
        for a, b in self.spans(size):
            if a % block or ((b - a) % block and b != self.full):
                raise ValueError(f"the slice {self.spans(size)} of a dim of {self.full} does "
                                 f"not fall on its {block}-wide scaling groups: tensor "
                                 f"parallelism splits in whole groups")

    def reduce_max(self, m: torch.Tensor) -> torch.Tensor:
        """The element-wise max of ``m`` over ``group`` (fp32, a copy)."""
        import torch.distributed as dist

        m = m.detach().float().contiguous().clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.group)
        return m

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The slices of ``t`` of every rank of ``group``, concatenated along
        ``dim`` in rank order (one all-gather; the slices are the equal,
        contiguous pieces of the ranks in that order), contiguous: the
        GEMMs that read it then take the unsharded operand's path."""
        import torch.distributed as dist

        n = dist.get_world_size(self.group)
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=self.group)
        return out.movedim(0, dim).contiguous()


@dataclasses.dataclass(frozen=True)
class LinearSplit:
    """How one rank holds a linear ``x (..., K) @ w (K, N)`` under tensor
    parallelism: the shards of the activation ``x``, the weight ``w`` and
    the back-propagated error ``e`` (..., N), each None where the rank
    holds the whole operand.  Column-parallel (``w[:, N_r]``): ``w`` on dim
    1 and ``e`` on its last dim; row-parallel (``w[K_r, :]``): ``x`` on its
    last dim and ``w`` on dim 0; ``pieces``, the rank's ``[a, b)`` of N
    (column) or K (row), concatenated; token-split (:meth:`tokens`): ``x``
    and ``e`` on their token dim."""

    x: Sharded | None
    w: Sharded | None
    e: Sharded | None

    @staticmethod
    def column(pieces, full: int, group=None) -> LinearSplit:
        return LinearSplit(None, Sharded(1, pieces, full, group), Sharded(-1, pieces, full, group))

    @staticmethod
    def row(pieces, full: int, group=None) -> LinearSplit:
        return LinearSplit(Sharded(-1, pieces, full, group), Sharded(0, pieces, full, group), None)

    @staticmethod
    def tokens(pieces, full: int, group=None) -> LinearSplit:
        """A whole weight on this rank's tokens (sequence parallelism): ``x``
        (..., S_r, K) and the error (..., S_r, N) token slices of a
        sequence of ``full`` (dim -2, the same pieces in every row).  The
        weight gradient contracts the tokens: this rank's part of the sum."""
        return LinearSplit(Sharded(-2, pieces, full, group), None, Sharded(-2, pieces, full, group))


def _full_shape(shape, shard: Sharded | None) -> tuple[int, ...]:
    return tuple(shape) if shard is None else shard.full_shape(shape)


def _check_splits(spec: GroupSpec, shape, shards: tuple[Sharded, ...]) -> tuple[Sharded, ...]:
    """A slice's groups must be the unsharded operand's: each piece of each
    shard's dim falls on group boundaries.  Returns the shards along whose
    dim one group spans the whole dim (their ranks then share each such
    group's max); along the others the slice holds whole groups of its
    own."""
    full = tuple(shape)
    for s in shards:
        full = s.full_shape(full)
    if len({s.axis(len(shape)) for s in shards}) < len(shards):
        raise ValueError("two shards of one operand split the same dim")
    b_full, b_local = spec.resolve(full), spec.resolve(shape)
    spanning = []
    for s in shards:
        ax = s.axis(len(shape))
        if b_full[ax] == full[ax] and shape[ax] < full[ax]:
            spanning.append(s)
            continue
        s.check_groups(shape[ax], b_full[ax])
        if b_local[ax] != b_full[ax]:
            raise ValueError(f"a slice of {shape[ax]} of dim {ax} of an operand {full} does "
                             f"not hold whole {b_full[ax]}-wide scaling groups")
    return tuple(spanning)


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


def _quantize_slice(x: torch.Tensor, cfg: QuantConfig, spec: GroupSpec, key: int | None,
                    idx: int, shards: tuple[Sharded, ...]):
    """``x``, the slice ``shards`` name of an operand that ``spec`` groups,
    quantized as that slice of the unsharded operand's quantization
    (module docstring): ``(MLSTensor, the shards a group spans)``."""
    spanning = _check_splits(spec, x.shape, shards)
    gen = rounding_generator(key, cfg, idx, x.device)
    offsets = None
    if gen is not None:
        full = tuple(x.shape)
        for s in shards:
            full = s.full_shape(full)
        offsets = torch.rand(full, generator=gen, device=gen.device, dtype=torch.float32) - 0.5
        for s in shards:
            offsets = s.take(offsets, x.shape[s.axis(x.ndim)])
    m = x.detach().float().abs().amax().reshape(1)
    for s in shards:
        m = s.reduce_max(m)
    group_max = None
    if spanning:  # the slice's part of each group; the group's max over the ranks
        block = list(spec.block)
        for s in spanning:
            block[s.axis(x.ndim)] = None
        spec = GroupSpec(tuple(block))

        def group_max(g):
            for s in spanning:
                g = s.reduce_max(g)
            return g
    t = mls_quantize(x, cfg.fmt, spec, cfg.gs_fmt, offsets, tensor_max=m[0],
                     group_max=group_max)
    return t, spanning


def quantize_operand(x: torch.Tensor, cfg: QuantConfig, spec: GroupSpec, key: int | None,
                     idx: int, r=None, wire: bool = False, shard: Sharded | None = None,
                     wire_shard: Sharded | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize -> ``(unit-scaled values, fp32 tensor scale)``: the tensor
    scale is factored out of the GEMM (paper Sec. V-B).  ``idx`` is the
    operand's rounding stream at the site (0: activation, 1: weight, 2:
    error); ``r`` gives the offsets instead (see :func:`lowbit_matmul`).
    ``shard``: ``x`` is that slice of the operand (``spec`` groups the
    unsharded one); it is quantized as the slice of the unsharded
    operand's quantization (module docstring).

    ``wire_shard`` (a 2-D weight under FSDP with ``packed_wire``): ``x`` is
    also this data rank's slice along that dim; it is quantized as a slice
    too, and its packed uint8 codes and compact group scales are gathered
    over ``wire_shard.group``, unpacked and broadcast: the unit values of
    the weight whole along that dim (still ``shard``'s slice), moved at 1 B
    an element.  A weight that cannot move as codes raises.

    With ``wire=True`` (a 2-D weight) and ``cfg.wire_fsdp_dim`` set, the
    values pass :func:`repro_torch.parallel.wire_pin` on that dim; with
    ``cfg.packed_wire`` too, as their packed uint8 codes and their compact
    group scales, each pinned, unpacked and broadcast after: the FSDP
    gather then moves 1 B an element.  The round trip is exact."""
    if wire_shard is not None and not (cfg.enabled and cfg.packed_wire
                                       and cfg.fmt.element_bits <= 8 and r is None):
        raise ValueError(f"a weight gathered over the data axis moves as packed codes: it "
                         f"needs quantization on, packed_wire, codes of at most 8 bits and "
                         f"its stream's offsets ({cfg.fmt}, packed_wire={cfg.packed_wire})")
    if not cfg.enabled:
        return x.to(torch.float32), torch.ones((), dtype=torch.float32, device=x.device)
    shards = tuple(s for s in (shard, wire_shard) if s is not None)
    spanning: tuple[Sharded, ...] = ()
    if not shards:
        t = mls_quantize(x, cfg.fmt, spec, cfg.gs_fmt, _source(key, cfg, idx, x.device, r))
    else:
        if r is not None:
            raise ValueError("a sharded operand draws its offsets from its stream, not r")
        t, spanning = _quantize_slice(x, cfg, spec, key, idx, shards)
    if wire_shard is not None:
        ax = wire_shard.axis(x.ndim)
        sign, mag = unpack_elements(wire_shard.gather(pack_elements(t), ax), cfg.fmt)
        # a group that spans the dim has its scale on every rank already
        sgc = t.s_g if wire_shard in spanning else wire_shard.gather(t.s_g, ax)
        return sign * mag * broadcast_groups(sgc, t.spec, wire_shard.full_shape(x.shape)), t.s_t
    pin = wire and cfg.wire_fsdp_dim is not None and x.ndim == 2
    if not pin:
        return t.unit_value(), t.s_t
    from repro_torch.parallel.sharding import wire_pin

    if cfg.packed_wire and t.fmt.element_bits <= 8:
        codes = wire_pin(pack_elements(t), cfg.wire_fsdp_dim)  # the 1-byte gather
        sign, mag = unpack_elements(codes, cfg.fmt)
        # the group scales travel compact (1/k_block of the elements) and
        # are broadcast after: broadcast first, they would be a full fp32 tensor
        sgc = wire_pin(t.s_g, min(cfg.wire_fsdp_dim, t.s_g.ndim - 1))
        return sign * mag * broadcast_groups(sgc, t.spec, x.shape), t.s_t
    return wire_pin(t.unit_value(), cfg.wire_fsdp_dim), t.s_t


def _error_spec(cfg: QuantConfig, shape) -> GroupSpec:
    """The groups of a matmul error of ``shape``: per (row, k-block) for
    "nc"/"c", else one."""
    if cfg.grouping in ("nc", "c"):
        return GroupSpec((1,) * (len(shape) - 1) + (min(cfg.k_block, shape[-1]),))
    return GroupSpec.per_tensor(len(shape))


class LowbitMatmul(torch.autograd.Function):
    """``x (..., K) @ w (K, N)`` with MLS fake-quantized operands and error;
    with a :class:`LinearSplit`, one rank's part of a tensor-parallel
    linear (its outputs, or partial sums where the split contracts)."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, r, split, wire):
        sp = split or LinearSplit(None, None, None)
        sx, sw = cfg.matmul_specs(_full_shape(x.shape, sp.x), _full_shape(w.shape, sp.w))
        qx, stx = quantize_operand(x, cfg, sx, key, 0, r, shard=sp.x)
        if wire is None:
            qw, stw = quantize_operand(w, cfg, sw, key, 1, r, wire=True, shard=sp.w)
        else:  # w stands for the gathered weight; its values are the data rank's slice
            qw, stw = quantize_operand(wire.local(), cfg, sw, key, 1, r, shard=sp.w,
                                       wire_shard=wire.shard)
        ctx.save_for_backward(qx, stx, qw, stw)
        ctx.conf = (key, cfg, r, sp, x.dtype, w.dtype)
        return torch.matmul(qx, qw) * (stx * stw)

    @staticmethod
    def backward(ctx, g):
        qx, stx, qw, stw = ctx.saved_tensors
        key, cfg, r, sp, x_dtype, w_dtype = ctx.conf
        ge, ste = quantize_operand(g.to(torch.float32), cfg,
                                   _error_spec(cfg, _full_shape(g.shape, sp.e)), key, 2, r,
                                   shard=sp.e)
        dx = torch.matmul(ge, qw.t()) * (ste * stw)  # paper l.15: qE @ qW^T
        dw = torch.matmul(qx.reshape(-1, qx.shape[-1]).t(),
                          ge.reshape(-1, ge.shape[-1])) * (ste * stx)  # l.13: qX^T @ qE
        return dx.to(x_dtype), dw.to(w_dtype), None, None, None, None, None


def lowbit_matmul(x: torch.Tensor, w: torch.Tensor, key: int | None,
                  cfg: QuantConfig, r=None, split: LinearSplit | None = None,
                  wire=None) -> torch.Tensor:
    """``x @ w`` with MLS-quantized operands; x: (..., K), w: (K, N).
    ``r``, where given, is ``(r_x, r_w, r_e)``: the rounding offsets of the
    activation, the weight and the error, each of its operand's shape, in
    place of the streams of ``key``.  ``split``: the operands are this
    rank's shards of a tensor-parallel linear (:class:`LinearSplit`).
    ``wire`` (a ``parallel.fsdp_wire.WireShard``): the weight is held
    sharded over the data axis and gathered here as packed codes; ``w`` is
    then its gather proxy (``WireShard.proxy``), whose gradient is the
    whole weight's (``quantize_operand``'s ``wire_shard``)."""
    return LowbitMatmul.apply(x, w, key, cfg, r, split, wire)


# Elements one pass of quantize_stack codes at a time (whole experts): it
# bounds the quantizer's fp32 temporaries at a few GiB on an expert stack
# of 671 M elements (llama4-scout's w_up: 16 x 5120 x 8192).
STACK_CHUNK = 1 << 27


def _stack_chunk(shape) -> int:
    """Whole slices of a stack of ``shape`` that one quantizer pass codes
    (and draws the offsets of) at a time."""
    return max(1, STACK_CHUNK // max(1, math.prod(shape[1:])))


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
    per = _stack_chunk(x.shape)
    for lo in range(0, n, per):
        xs = x[lo:lo + per].to(torch.float32)
        if isinstance(r, torch.Generator):
            rs = torch.rand(xs.shape, generator=r, device=r.device, dtype=torch.float32) - 0.5
        else:
            rs = None if r is None else r[lo:lo + per]
        sign, s_t[lo:lo + per], _, _, _, scale, x_f = normalize_slices(xs, full, cfg.gs_fmt)
        unit[lo:lo + per] = sign.to(torch.float32) * scale * quantize_grid(x_f, cfg.fmt, rs)
    return unit, s_t


def stack_offsets(gen: torch.Generator, shape, first: int, n: int) -> torch.Tensor:
    """The rounding offsets of slices ``[first, first + n)`` of a stack of
    ``shape`` that :func:`quantize_stack` draws from ``gen``: the whole
    stack's draws, made chunk by chunk as the unsharded stack makes them,
    kept where they fall in the range (a rank's experts of a stack split
    over a model axis)."""
    shape = tuple(shape)
    per = _stack_chunk(shape)
    out = torch.empty((n,) + shape[1:], dtype=torch.float32, device=gen.device)
    for lo in range(0, first + n, per):
        hi = min(lo + per, shape[0])
        d = torch.rand((hi - lo,) + shape[1:], generator=gen, device=gen.device,
                       dtype=torch.float32) - 0.5
        a, b = max(lo, first), min(hi, first + n)
        if a < b:
            out[a - first:b - first] = d[a - lo:b - lo]
    return out


def _stack_source(key, cfg: QuantConfig, idx: int, shape, device, r, experts):
    """Operand ``idx``'s rounding source in a stack of ``shape``; with
    ``experts = (first, full)`` the stack is slices ``[first, first +
    shape[0])`` of one of ``full``, whose stream's offsets it takes."""
    src = _source(key, cfg, idx, device, r)
    if experts is None or not isinstance(src, torch.Generator):
        return src
    first, full = experts
    return stack_offsets(src, (full,) + tuple(shape[1:]), first, shape[0])


# torch.profiler spans of the stacked GEMM's forward and backward (what a
# trace reads as the MoE experts' fake-quant time)
STACK_SPANS = ("lowbit_matmul_stack", "lowbit_matmul_stack.backward")


class LowbitMatmulStack(torch.autograd.Function):
    """``x (E, R, K) @ w (E, K, N)``: E independent :class:`LowbitMatmul`,
    each operand of the stack quantized at once (:func:`quantize_stack`)."""

    @staticmethod
    def forward(ctx, x, w, key, cfg, r, experts):
        with torch.profiler.record_function(STACK_SPANS[0]):
            sx, sw = cfg.matmul_specs(x.shape[1:], w.shape[1:])
            qx, stx = quantize_stack(x, cfg, sx,
                                     _stack_source(key, cfg, 0, x.shape, x.device, r, experts))
            qw, stw = quantize_stack(w, cfg, sw,
                                     _stack_source(key, cfg, 1, w.shape, x.device, r, experts))
            ctx.save_for_backward(qx, stx, qw, stw)
            ctx.conf = (key, cfg, r, experts, x.dtype, w.dtype)
            return torch.matmul(qx, qw) * (stx * stw)[:, None, None]

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function(STACK_SPANS[1]):
            qx, stx, qw, stw = ctx.saved_tensors
            key, cfg, r, experts, x_dtype, w_dtype = ctx.conf
            ge, ste = quantize_stack(g.to(torch.float32), cfg, _error_spec(cfg, g.shape[1:]),
                                     _stack_source(key, cfg, 2, g.shape, g.device, r, experts))
            dx = torch.matmul(ge, qw.transpose(1, 2)) * (ste * stw)[:, None, None]
            dw = torch.matmul(qx.transpose(1, 2), ge) * (ste * stx)[:, None, None]
            return dx.to(x_dtype), dw.to(w_dtype), None, None, None, None


def lowbit_matmul_stack(x: torch.Tensor, w: torch.Tensor, key: int | None,
                        cfg: QuantConfig, r=None,
                        experts: tuple[int, int] | None = None) -> torch.Tensor:
    """``x (E, R, K) @ w (E, K, N)`` -> fp32 (E, R, N): for each ``e``,
    :func:`lowbit_matmul` of ``x[e]`` and ``w[e]`` (its own tensor and group
    scales), in some 40 operations per operand for the whole stack.  The
    rounding offsets of each operand come from one stream of ``key`` for
    the whole stack, or from ``r = (r_x, r_w, r_e)`` of the stacked shapes.
    ``experts = (first, full)``: the operands are slices ``[first, first +
    E)`` of a stack of ``full`` (a rank's experts), each quantized bit for
    bit as in the whole stack: the streams are drawn at the whole stack's
    shape (:func:`stack_offsets`), and no scale spans two slices."""
    return LowbitMatmulStack.apply(x, w, key, cfg, r, experts)


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
