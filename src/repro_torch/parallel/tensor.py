"""Tensor parallelism over the mesh's ``model`` axis for the LM families.

What GSPMD does for the JAX package on this family (its ``shard(...)``
constraints place each op; the function computed is the unsharded one),
done here by hand on per-rank local tensors, Megatron's way:

* :func:`copy_to_tp`: identity forward, all-reduce SUM backward (the input
  of a column-parallel linear: every rank holds it whole, and each adds a
  partial data gradient);
* :func:`reduce_from_tp`: all-reduce SUM forward, identity backward (the
  output of a row-parallel linear: each rank holds a partial sum).

The layout is the JAX package's (:func:`repro_torch.parallel.specs.param_shardings`
on a mesh with a ``model`` axis names the dim of each parameter that
``heads``, ``kv_heads``, ``mlp`` and ``vocab`` put on ``model``, and
leaves replicated what the axis does not divide), with rules of the
port's own that keep whole heads and whole scaling groups
(:func:`tp_layout`):

* a contraction dim is split in whole scaling groups of the width the
  backend uses on it (``k_block`` on the quantized backend; on the
  fake-quant one ``QuantConfig._aligned_kb`` and the error's
  ``min(k_block, d)``), ⌈G/m⌉ groups to the first ``G % m`` ranks and
  ⌊G/m⌋ to the rest: chatglm3-6b's d_ff 13696 (107 groups of 128) splits
  6912 / 6784 at model 2, where JAX splits it evenly (6848 each) and lets
  GSPMD regroup;
* an attention's query heads split in whole units of ``u = lcm(hd, gw) /
  hd`` heads (whole heads and whole scaling groups), ⌈U/m⌉ of its ``U``
  units to the first ``U % m`` ranks and ⌊U/m⌋ to the rest
  (:func:`attention_heads`): yi-34b's 56 heads split 4 / 3 at model 16,
  where JAX splits their columns evenly (3.5 heads a device).  The kv
  heads split with them only where both split evenly in whole groups;
  else (chatglm3-6b's 2 at model 4, any uneven split) they stay
  replicated and each rank attends with the kv heads its query heads map
  to, ``[h0 // g, (h1 - 1) // g + 1)`` (:func:`rank_heads`), query head
  ``h`` reading local kv head ``h // g - kv0`` (:func:`kv_map`);
* an attention with fewer units than ranks (seamless-m4t-medium's heads
  of 64 at model 16, zamba2-7b's shared block's of 112 at 8) stays
  replicated whole, ``wq``, ``wk``, ``wv``, ``wo`` and their biases, as
  JAX's experts do where the axis does not divide them: every rank
  computes every head, with no collective, its quantized operands on K1's
  one-call entry (the unsharded layer's outputs, bit for bit), its weight
  gradients whole on every rank, like a norm's.

Quantized operands are quantized as slices of the unsharded operands
(:class:`repro_torch.core.lowbit.LinearSplit`): the tensor scale is the
max over the model group (all-reduce MAX), the group scales are local, the
rounding bytes are the slice of the unsharded operand's.  So a
column-parallel linear's outputs and weight gradient, and a row-parallel
one's data and weight gradient, are the unsharded ones' slices bit for
bit; the sums over the split (a column-parallel data gradient, a
row-parallel output) differ from the unsharded ones in their order only.

The embedding is a vocab-parallel lookup (the other ranks add zeros), the
unquantized LM head column-parallel over vocab, and the loss a
vocab-parallel cross-entropy; a vocabulary the model size does not divide
(mamba2-370m's 50280 at model 16) stays replicated, as JAX's ``spec_for``
keeps it: a plain lookup, head and loss on every rank.

The ssm and hybrid families' Mamba2 layers split by parts, where JAX
splits ``in_proj``'s packed output dim (``z``, ``x``, ``B``, ``C``,
``dt``) evenly and GSPMD regroups (:func:`mamba_heads`):

* ``z``, ``x`` and ``out_proj``'s rows split by heads, in whole units of
  ``lcm(group width, ssm_headdim)`` (⌈U/m⌉ units to the first ranks), and
  the ``x`` channels of ``conv_w`` / ``conv_b`` with them;
* the tail ``[2 din, N)`` (``B``, ``C``, ``dt``; its ``dt`` is a ragged
  scaling group on the quantized backend, which a split by heads would
  cut) stays whole on rank 0 with its conv channels: rank 0 computes
  ``silu(conv(B, C))`` and the raw ``dt`` and :func:`broadcast_from_tp`
  sends them to every rank, which takes the ``dt`` of its heads.  Every
  ``in_proj`` column lives on one rank, so the column-parallel data
  gradient adds each term once;
* ``A_log``, ``D``, ``dt_bias`` and ``out_norm``'s gain, replicated in
  JAX, split by heads here (a port rule: no gradient of them is summed
  over the group, and the grad norm counts each element once);
* ``out_norm``, an RMSNorm over the whole ``din``, sums its squares over
  the group with :func:`sum_over_tp` (SUM forward and SUM backward).

The hybrid's shared attention+MLP block splits by the dense rules.

The moe family's expert stacks (``moe.w_gate``, ``moe.w_up``,
``moe.w_down``; logical axis ``expert``, which JAX binds to ``model``)
split along their expert dim, ``E / m`` whole experts a rank; where ``m``
does not divide ``E`` they stay replicated, as JAX's ``spec_for`` drops an
axis that does not divide.  No contraction dim of an expert is split, so
no scaling group straddles ranks, and each expert has its own tensor
scale: no MAX all-reduce.  The router stays replicated, the shared expert
splits by the dense MLP rules, and the experts' outputs are gathered
whole before the combine (:mod:`repro_torch.models.moe`).  The encdec
family's encoder blocks, self-attention, cross-attention and MLPs split
by the dense rules (cross-attention's ``wk``/``wv`` column-parallel over
the encoder's output); ``frontend_proj`` stays replicated.

Serving, a rank holds its part of the caches (``models.lm.cache_spec``
with ``tp``: the kv heads its query heads read, its Mamba2 heads' states,
its heads of the cross-attention K/V), and the logits are gathered whole
on every rank by an all-reduce SUM of each rank's vocabulary slice placed
in zeros (``models.lm.whole_logits``; exact).

Sequence parallelism (``tensor_parallel(..., seq_shard=True)``; JAX's
``SP_RULES``, ``seq -> model``) splits the residual stream too: between
the layers' linears a rank holds its tokens ``[r S/m, (r+1) S/m)`` of
every row (:class:`SeqShard`), and the norms and residual adds run on
them.  Where heads or hidden dims split (Megatron's layout) the
column-parallel entries gather the sequence (:func:`gather_seq`:
all-gather forward, reduce-scatter backward) and the row-parallel exits
reduce-scatter it (:func:`scatter_seq`), so every quantized operand is the
DEFAULT layout's, and at a model axis of 2 the step is the DEFAULT step's
bit for bit (two partials add the same either way).  Where a dim does not
split, JAX's own SP layout: an attention kept whole (and the replicated
kv linears of an uneven split) runs ``wq``, ``wk``, ``wv`` and ``wo`` on
the rank's own tokens, its operands quantized as token slices of the
unsharded ones (``LinearSplit.tokens``), and gathers K and V along the
sequence (the queries stay split, the causal mask offset by the rank's
first position); a vocabulary kept whole runs its head and loss on the
rank's tokens, the loss's token sum all-reduced.  A sequence the axis does
not divide (or whose rank slice is not whole scaling groups where a token
slice is quantized on K1/K3, and any decode step) stays whole: that call
runs the DEFAULT layout.  Parameters replicated over ``model`` then take
gradients from the rank's tokens only; the trainer sums them over the
group (:func:`partial_grads`).  The collectives are ``all_reduce`` (SUM,
MAX), ``all_gather_into_tensor`` and ``reduce_scatter_tensor``, which gloo
runs on CUDA tensors as well as CPU ones.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping

import torch
import torch.distributed as dist

from repro_torch.core.lowbit import LinearSplit

from .sharding import DEFAULT_RULES
from .specs import logical_axes_for

__all__ = ["NOT_PORTED", "PORTED", "TAIL_RANK", "SeqShard", "Split", "TPLinear", "TensorParallel",
           "all_reduce_max", "attention_heads", "broadcast_from_tp", "copy_to_tp", "gather_seq",
           "gather_whole",
           "kv_map", "mamba_heads", "partial_grads", "rank_heads", "reduce_from_tp",
           "scatter_seq", "seq_unit", "shard_state_dict", "split_seq", "sum_over_tp", "take_seq",
           "tensor_parallel", "tp_layout", "vocab_parallel_ce"]

PORTED = ("dense", "moe", "ssm", "hybrid", "encdec")
NOT_PORTED = ("tensor parallelism over the 'model' axis takes the LM families " + ", ".join(PORTED)
              + ", not {family!r}")
TAIL_RANK = 0  # the rank that holds a Mamba2 in_proj's tail (B, C, dt)


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """One rank of a model group: ``rank`` of ``size``, the ``torch.distributed``
    process ``group``."""

    rank: int
    size: int
    group: object = dataclasses.field(default=None, compare=False)

    @staticmethod
    def of(group=None) -> TensorParallel:
        """This rank of ``group`` (None: the whole world)."""
        group = group or dist.group.WORLD
        return TensorParallel(dist.get_rank(group), dist.get_world_size(group), group)


# ---------------------------------------------------------------------------
# the conjugate collectives
# ---------------------------------------------------------------------------
def _all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    t = t.contiguous().clone()
    dist.all_reduce(t, op=op, group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumOverTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _BroadcastFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, anchor, group, is_root):
        ctx.group, ctx.is_root = group, is_root
        return _all_reduce(x, group)  # the other ranks send zeros

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group)
        return (g if ctx.is_root else None), None, None, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """Identity forward; the gradient summed over the model group."""
    return _CopyToTP.apply(x, tp.group)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the model group; the gradient passed through."""
    return _ReduceFromTP.apply(x, tp.group)


def sum_over_tp(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The sum over the model group where every rank's output depends on
    every rank's input (a norm's sum of squares): the gradient summed over
    the group too."""
    return _SumOverTP.apply(x, tp.group)


def broadcast_from_tp(x: torch.Tensor | None, like: tuple, anchor: torch.Tensor,
                      tp: TensorParallel, root: int = TAIL_RANK) -> torch.Tensor:
    """Rank ``root``'s ``x`` on every rank (``like``: its ``(shape, dtype)``,
    which the other ranks, whose ``x`` is None, receive); the gradient
    summed over the group and handed to ``root``.  ``anchor``, a tensor of
    the graph on every rank, makes every rank run the backward's
    collective where ``root``'s does."""
    if tp.rank == root:
        if x is None or (tuple(x.shape), x.dtype) != (tuple(like[0]), like[1]):
            raise ValueError(f"rank {root} broadcasts a tensor of {like}")
    else:
        x = torch.zeros(like[0], dtype=like[1], device=anchor.device)
    return _BroadcastFromTP.apply(x, anchor, tp.group, tp.rank == root)


def all_reduce_max(x: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """The element-wise max over the model group (no gradient)."""
    return _all_reduce(x.detach(), tp.group, dist.ReduceOp.MAX)


# ---------------------------------------------------------------------------
# sequence parallelism: the residual stream split along the sequence
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class SeqShard:
    """A sequence of ``full`` positions split evenly over the model group
    ``tp``: rank ``r`` holds ``[r n, (r + 1) n)`` of every row, ``n = full /
    size`` (dim 1 of a ``(B, S, ...)`` tensor)."""

    tp: TensorParallel
    full: int

    @property
    def n(self) -> int:
        return self.full // self.tp.size

    @property
    def start(self) -> int:
        return self.tp.rank * self.n

    def take(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's positions of a whole sequence (a view)."""
        return t.narrow(dim, self.start, self.n)

    def split(self) -> LinearSplit:
        """A replicated linear run on this rank's tokens: ``x`` and the
        error token slices of the unsharded operands."""
        return LinearSplit.tokens(((self.start, self.start + self.n),), self.full,
                                  self.tp.group)


def split_seq(tp: TensorParallel | None, full: int, unit: int = 1) -> SeqShard | None:
    """The split of a sequence of ``full`` positions over ``tp``'s group, or
    None where it stays whole: no model group, a size the group does not
    divide, or a rank slice that is not whole ``unit``s (:func:`seq_unit`)."""
    if tp is None or tp.size == 1 or full % tp.size or (full // tp.size) % unit:
        return None
    return SeqShard(tp, full)


def seq_unit(cfg, size: int) -> int:
    """The positions a rank's slice of the sequence must hold whole: the
    scaling group of the quantized backend where some linear runs on a
    token slice (an attention kept whole, or replicated kv linears), whose
    weight gradient contracts the tokens in groups on K3; else 1."""
    qcfg = cfg.qcfg()
    if not cfg.n_heads or qcfg is None or not qcfg.enabled or qcfg.backend != "quantized":
        return 1
    heads = attention_heads(cfg, size)
    if heads is not None and rank_heads(cfg, size, 0)[2] is None:
        return 1  # every attention linear splits by heads: no token slice
    return qcfg.k_block


def _gather_seq(x: torch.Tensor, sp: SeqShard) -> torch.Tensor:
    """(B, n, ...) of every rank -> (B, S, ...): one all_gather_into_tensor of
    the ranks' slices, concatenated along the first dim (rank-major)."""
    m, group = sp.tp.size, sp.tp.group
    src = x.contiguous()
    out = src.new_empty((m * src.shape[0],) + tuple(src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    out = out.reshape((m,) + tuple(x.shape)).movedim(0, 1)
    return out.reshape((x.shape[0], m * x.shape[1]) + tuple(x.shape[2:]))


def _scatter_seq(x: torch.Tensor, sp: SeqShard) -> torch.Tensor:
    """(B, S, ...) partial sums of every rank -> this rank's (B, n, ...) of
    their sum: one reduce_scatter_tensor of the ranks' slices, concatenated
    along the first dim (rank-major)."""
    m, group = sp.tp.size, sp.tp.group
    b, s = x.shape[:2]
    rest = tuple(x.shape[2:])
    src = x.reshape((b, m, s // m) + rest).movedim(1, 0).reshape((m * b, s // m) + rest)
    src = src.contiguous()
    out = src.new_empty((b, s // m) + rest)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _gather_seq(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _scatter_seq(g, ctx.sp), None


class _ScatterSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return _scatter_seq(x, sp)

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.sp), None


class _GatherWhole(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp, gathered):
        ctx.sp = sp
        return _gather_seq(x, sp) if gathered is None else gathered.clone()

    @staticmethod
    def backward(ctx, g):
        return ctx.sp.take(g).contiguous(), None, None


class _TakeSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sp):
        ctx.sp = sp
        return sp.take(x).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather_seq(g, ctx.sp), None


def gather_seq(x: torch.Tensor, sp: SeqShard) -> torch.Tensor:
    """The whole sequence from every rank's ``(B, n, ...)`` slice (a
    column-parallel entry); the gradient reduce-scattered: each rank's
    partial gradient of the whole sequence summed, this rank's slice
    kept."""
    return _GatherSeq.apply(x, sp)


def scatter_seq(x: torch.Tensor, sp: SeqShard) -> torch.Tensor:
    """This rank's slice of the sum over the group of every rank's partial
    ``(B, S, ...)`` (a row-parallel exit); the gradient all-gathered."""
    return _ScatterSeq.apply(x, sp)


def gather_whole(x: torch.Tensor, sp: SeqShard, gathered: torch.Tensor | None = None
                 ) -> torch.Tensor:
    """The whole sequence from every rank's slice, for a region that every
    rank computes whole and whose gradient every rank then holds whole: the
    gradient handed back as this rank's slice (no collective).  Its
    conjugate is :func:`take_seq`.  ``gathered``: that whole sequence
    again (no collective), for a second consumer whose gradient must reach
    ``x`` on its own."""
    return _GatherWhole.apply(x, sp, gathered)


def take_seq(x: torch.Tensor, sp: SeqShard) -> torch.Tensor:
    """This rank's slice of a sequence that every rank holds whole; the
    gradient all-gathered, whole on every rank."""
    return _TakeSeq.apply(x, sp)


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Split:
    """A parameter split along ``dim``: rank ``r`` holds the ``[a, b)`` of
    ``pieces[r]``, concatenated in that order."""

    dim: int
    pieces: tuple[tuple[tuple[int, int], ...], ...]

    @staticmethod
    def of_bounds(dim: int, bounds) -> Split:
        """One piece a rank: rank ``r`` holds ``bounds[r]``."""
        return Split(dim, tuple(((a, b),) for a, b in bounds))

    @property
    def bounds(self) -> tuple[tuple[int, int], ...]:
        """Rank ``r``'s ``[a, b)`` where each rank holds one piece."""
        if any(len(p) != 1 for p in self.pieces):
            raise ValueError(f"a rank holds several pieces: {self.pieces}")
        return tuple(p[0] for p in self.pieces)

    @property
    def full(self) -> int:
        return max(b for p in self.pieces for _, b in p)

    def size(self, rank: int) -> int:
        return sum(b - a for a, b in self.pieces[rank])

    def take(self, t: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s part of the unsharded ``t`` (a view where it is one
        piece)."""
        parts = [t.narrow(self.dim, a, b - a) for a, b in self.pieces[rank]]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.dim)


def _group_width(qcfg, d: int) -> int:
    """The width a split of a dim of ``d`` must keep whole: the scaling
    group of every GEMM that contracts it (1 unquantized)."""
    if qcfg is None or not qcfg.enabled:
        return 1
    if qcfg.grouping != "nc":
        raise ValueError(f"tensor parallelism takes grouping 'nc', not {qcfg.grouping!r}: "
                         f"K2's column groups would span the ranks")
    if qcfg.backend == "quantized":
        return qcfg.k_block
    return math.lcm(qcfg._aligned_kb(d), min(qcfg.k_block, d))


def _in_groups(d: int, unit: int, size: int) -> tuple[tuple[int, int], ...]:
    """``d`` split in whole ``unit``s (the last may be ragged), the first
    ``G % size`` ranks one unit more."""
    groups = -(-d // unit)
    if groups < size:
        raise ValueError(f"a dim of {d} has {groups} groups of {unit}: fewer than the "
                         f"{size} ranks of the model axis")
    per, extra = divmod(groups, size)
    bounds, g0 = [], 0
    for r in range(size):
        g1 = g0 + per + (r < extra)
        bounds.append((min(g0 * unit, d), min(g1 * unit, d)))
        g0 = g1
    return tuple(bounds)


def _even(d: int, size: int) -> tuple[tuple[int, int], ...]:
    n = d // size
    return tuple((r * n, (r + 1) * n) for r in range(size))


_MAMBA_PARTS = ("in_proj.w", "out_proj.w", "conv_w", "conv_b", "A_log", "D", "dt_bias",
                "out_norm.gamma")


def mamba_heads(cfg, size: int) -> tuple[tuple[int, int], ...]:
    """Each rank's ``[h0, h1)`` of a Mamba2 layer's heads at a model axis of
    ``size``: whole units of ``lcm(group width, ssm_headdim)`` channels of
    ``din``, ⌈U/m⌉ units to the first ranks.  Raises where the heads read
    several B/C groups (both Mamba2 configs have one), where ``din`` is not
    whole units, or where it has fewer units than ranks."""
    din, hd = cfg.d_inner, cfg.ssm_headdim
    if cfg.ssm_groups != 1:
        raise ValueError(f"a Mamba2 layer splits by heads with one B/C group, not "
                         f"{cfg.ssm_groups}")
    unit = math.lcm(_group_width(cfg.qcfg(), din), hd)
    if din % unit:
        raise ValueError(f"a Mamba2 din of {din} is not whole units of {unit} (scaling groups "
                         f"and heads of {hd})")
    return tuple((a // hd, b // hd) for a, b in _in_groups(din, unit, size))


def _mamba_layout(cfg, shapes: Mapping[str, tuple[int, ...]], size: int) -> dict[str, Split]:
    """The Mamba2 layers' splits (module docstring): by heads, the in_proj's
    and conv's tail on :data:`TAIL_RANK`."""
    din, hd, gn = cfg.d_inner, cfg.ssm_headdim, cfg.ssm_state
    heads = mamba_heads(cfg, size)
    cols = [((h0 * hd, h1 * hd),) for h0, h1 in heads]
    out = {}
    for name, shape in shapes.items():
        part = next((p for p in _MAMBA_PARTS if name.endswith("." + p)), None)
        if not name.startswith("layers.") or part is None:
            continue
        if part == "in_proj.w":
            n = shape[1]
            pieces = [((a, b), (din + a, din + b)) + (((2 * din, n),) if r == TAIL_RANK else ())
                      for r, ((a, b),) in enumerate(cols)]
            out[name] = Split(1, tuple(pieces))
        elif part in ("conv_w", "conv_b"):
            out[name] = Split(0, tuple(c + (((din, din + 2 * gn),) if r == TAIL_RANK else ())
                                       for r, c in enumerate(cols)))
        elif part in ("out_proj.w", "out_norm.gamma"):
            out[name] = Split(0, tuple(cols))
        else:  # A_log, D, dt_bias: one per head
            out[name] = Split.of_bounds(0, heads)
    return out


def attention_heads(cfg, size: int) -> tuple[tuple[int, int], ...] | None:
    """Each rank's ``[h0, h1)`` of an attention's query heads at a model axis
    of ``size``: whole units of ``lcm(hd, gw) / hd`` heads (``gw`` the
    scaling group of the heads' dim), ⌈U/m⌉ units to the first ``U % m``
    ranks; None where the units are fewer than the ranks (the attention
    stays replicated)."""
    hd = cfg.hd
    d = cfg.n_heads * hd
    unit = math.lcm(hd, _group_width(cfg.qcfg(), d))
    if -(-d // unit) < size:
        return None
    return tuple((a // hd, b // hd) for a, b in _in_groups(d, unit, size))


def _kv_split(cfg, heads, size: int) -> bool:
    """Whether the kv heads split with the query heads ``heads``: both
    evenly, ``n_kv / size`` kv heads a rank in whole scaling groups."""
    if heads is None or cfg.n_kv_heads % size or cfg.n_heads % size:
        return False
    if any(h1 - h0 != cfg.n_heads // size for h0, h1 in heads):
        return False
    d = cfg.n_kv_heads * cfg.hd
    return (d // size) % _group_width(cfg.qcfg(), d) == 0


_MODEL_AXES = {a for a, e in DEFAULT_RULES.rules if e == "model"}


def tp_layout(cfg, shapes: Mapping[str, tuple[int, ...]], size: int) -> dict[str, Split]:
    """``{name: Split}`` of every parameter of a ``cfg`` model (``shapes``:
    name -> unsharded shape) that the model axis of ``size`` splits; the
    others are replicated.  The split dims are those whose logical axis
    (``logical_axes_for``) the rules put on ``model`` (and, of a Mamba2
    layer, the heads' dims of ``A_log``, ``D``, ``dt_bias`` and
    ``out_norm``); the bounds follow the module docstring's rules: heads
    in whole units (an attention with fewer units than ranks replicated),
    hidden dims in whole groups, a vocabulary or an expert stack the model
    size does not divide replicated, as ``param_shardings`` drops the
    axis.  Raises on a family not ported, on grouping other than "nc" and
    on a hidden dim with fewer scaling groups than ranks."""
    if cfg.family not in PORTED:
        raise NotImplementedError(NOT_PORTED.format(family=cfg.family))
    if size == 1:
        return {}
    qcfg = cfg.qcfg()
    heads = attention_heads(cfg, size) if cfg.n_heads else None
    kv_split = _kv_split(cfg, heads, size)
    out = _mamba_layout(cfg, shapes, size) if cfg.family in ("ssm", "hybrid") else {}
    for name, shape in shapes.items():
        if name in out:
            continue
        logical = logical_axes_for(name, len(shape))
        dims = [d for d, a in enumerate(logical) if a in _MODEL_AXES]
        if not dims:
            continue
        dim = dims[0]
        axis, d = logical[dim], shape[dim]
        if axis == "heads":
            if heads is None:
                continue  # fewer units than ranks: the attention stays replicated
            bounds = tuple((h0 * cfg.hd, h1 * cfg.hd) for h0, h1 in heads)
        elif axis == "kv_heads":
            if not kv_split:
                continue  # replicated: each rank uses the kv heads its q heads map to
            bounds = _even(d, size)
        elif axis == "mlp":
            bounds = _in_groups(d, _group_width(qcfg, d), size)
        elif axis in ("vocab", "expert"):
            if d % size:
                continue  # JAX's spec_for drops the axis: replicated
            bounds = _even(d, size)  # the embedding and head; whole experts
        else:
            raise NotImplementedError(f"{name}: the logical axis {axis!r} on 'model' is not "
                                      f"ported (ROADMAP queue 1)")
        out[name] = Split.of_bounds(dim, bounds)
    return out


def rank_heads(cfg, size: int, rank: int) -> tuple[int, int, tuple[int, int] | None]:
    """Rank ``rank``'s attention heads at a model axis of ``size``: ``(query
    heads, kv heads, kv_take)``; ``kv_take`` is None where the kv heads split
    (``n_kv / size`` each) or the attention stays replicated (all heads),
    else the ``[kv0, kv1)`` of the replicated kv heads its query heads
    ``[h0, h1)`` map to, ``[h0 // g, (h1 - 1) // g + 1)`` with ``g =
    n_heads / n_kv``."""
    heads = attention_heads(cfg, size)
    if heads is None:
        return cfg.n_heads, cfg.n_kv_heads, None
    h0, h1 = heads[rank]
    if _kv_split(cfg, heads, size):
        return h1 - h0, cfg.n_kv_heads // size, None
    group = cfg.n_heads // cfg.n_kv_heads
    kv0, kv1 = h0 // group, (h1 - 1) // group + 1
    return h1 - h0, kv1 - kv0, (kv0, kv1)


def kv_map(cfg, size: int, rank: int) -> tuple[int, ...] | None:
    """The local kv head each of rank ``rank``'s query heads reads (query head
    ``h`` kv head ``h // g - kv0``), or None where the grouped layout reads
    them (each kv head read by the same number of consecutive query
    heads)."""
    hq, hkv, take = rank_heads(cfg, size, rank)
    if take is None:
        return None
    h0 = attention_heads(cfg, size)[rank][0]
    group = cfg.n_heads // cfg.n_kv_heads
    local = tuple(h // group - take[0] for h in range(h0, h0 + hq))
    if hq % hkv == 0 and local == tuple(i // (hq // hkv) for i in range(hq)):
        return None
    return local


def shard_state_dict(state: Mapping[str, torch.Tensor], layout: Mapping[str, Split],
                     rank: int) -> dict[str, torch.Tensor]:
    """Rank ``rank``'s tensors of an unsharded state dict (e.g. a JAX
    model's, :func:`repro_torch.convert.lm_params_from_jax`): each split
    tensor's part (a copy), the others as they are."""
    return {k: layout[k].take(t, rank).clone() if k in layout else t for k, t in state.items()}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class TPLinear:
    """How a :class:`repro_torch.models.nn.Linear` runs on one rank:
    ``"column"`` (``w[:, N_r]``: the input held whole, outputs ``N_r``) or
    ``"row"`` (``w[K_r, :]``: the input's ``K_r``, the output summed over
    the group, then the bias); ``N_r`` (``K_r``) is the ``pieces`` of the
    dim of ``full``, concatenated."""

    kind: str
    pieces: tuple[tuple[int, int], ...]
    full: int
    tp: TensorParallel

    @staticmethod
    def of(kind: str, split: Split, tp: TensorParallel) -> TPLinear:
        """Rank ``tp.rank``'s linear of a weight split ``split``."""
        return TPLinear(kind, split.pieces[tp.rank], split.full, tp)

    @property
    def split(self) -> LinearSplit:
        make = LinearSplit.column if self.kind == "column" else LinearSplit.row
        return make(self.pieces, self.full, self.tp.group)

    def __call__(self, linear, x, w, b, qcfg, key, wire, seq: SeqShard | None = None):
        """``seq``: the sequence is split (a row-parallel output is
        reduce-scattered to this rank's tokens, then the bias added)."""
        if self.kind == "column":
            return linear(x, w, b, qcfg, key, wire, split=self.split)
        y = linear(x, w, None, qcfg, key, wire, split=self.split)
        y = reduce_from_tp(y, self.tp) if seq is None else scatter_seq(y, seq)
        return y if b is None else y + b.float()


_KINDS = {"wq": "column", "wk": "column", "wv": "column", "wo": "row",
          "w_up": "column", "w_gate": "column", "w_down": "row"}


def _mark_linears(module, prefix: str, layout: Mapping[str, Split], tp: TensorParallel) -> bool:
    """The split linears of an attention or MLP (``prefix`` its name) made
    column- or row-parallel, and the module told its group; kv linears
    whose heads stay whole stay replicated.  An attention none of whose
    linears split stays replicated whole (no group).  Returns whether it
    split."""
    split = False
    for name, kind in _KINDS.items():
        sp = layout.get(f"{prefix}{name}.w")
        if sp is not None:
            getattr(module, name).tp = TPLinear.of(kind, sp, tp)
            split = True
    if split:
        module.tp = tp
    return split


def _mark_block(block, prefix: str, layout: Mapping[str, Split], tp: TensorParallel) -> None:
    """A transformer block (``prefix`` its name) run tensor-parallel: a dense
    or encoder :class:`Block`, an ``MoEBlock`` (its attention, its shared
    expert's MLP, its experts) or an ``XDecBlock`` (self- and
    cross-attention, MLP).  Each attention is told its heads: split (its
    query and kv heads), uneven (its query heads, the ``kv_take`` of the
    replicated kv heads and, where the grouped layout does not read them,
    the ``kv_map``) or replicated (left whole: no group, every head)."""
    for sub in ("attn", "xattn"):
        attn = getattr(block, sub, None)
        if attn is None or not _mark_linears(attn, f"{prefix}{sub}.", layout, tp):
            continue
        hq, hkv, attn.kv_take = rank_heads(attn.cfg, tp.size, tp.rank)
        attn.heads = (hq, hkv)
        attn.kv_map = kv_map(attn.cfg, tp.size, tp.rank)
    moe = getattr(block, "moe", None)
    if moe is None:
        _mark_linears(block.mlp, f"{prefix}mlp.", layout, tp)
        return
    if moe.shared is not None:
        _mark_linears(moe.shared, f"{prefix}moe.shared.", layout, tp)
    sp = layout.get(f"{prefix}moe.w_gate")
    if sp is not None:  # experts the model axis does not divide stay replicated
        moe.tp, moe.experts = tp, sp.bounds[tp.rank]


def tensor_parallel(model, tp: TensorParallel, seq_shard: bool = False):
    """Make ``model`` (an unsharded :class:`repro_torch.models.lm.LM`) rank
    ``tp.rank``'s part of it, in place: each split parameter narrowed to
    its part, its linears marked column- or row-parallel, its attention
    told its heads, its Mamba2 layers theirs and its MoE layers their
    experts, and ``model.tp`` / ``model.tp_layout`` set.  ``seq_shard``:
    sequence parallelism too (``model.seq_shard``; the module docstring),
    each call's sequence split where the axis divides it.  Returns the
    model."""
    cfg = model.cfg
    layout = tp_layout(cfg, {k: tuple(p.shape) for k, p in model.named_parameters()}, tp.size)
    params = dict(model.named_parameters())
    local = shard_state_dict({k: params[k].data for k in layout}, layout, tp.rank)
    for name, t in local.items():
        params[name].data = t
    heads = mamba_heads(cfg, tp.size)[tp.rank] if cfg.family in ("ssm", "hybrid") else None
    for i, layer in enumerate(model.enc_layers or ()):
        _mark_block(layer, f"enc_layers.{i}.", layout, tp)
    for i, layer in enumerate(model.layers):
        if heads is None:
            _mark_block(layer, f"layers.{i}.", layout, tp)
            continue
        layer.in_proj.tp = TPLinear.of("column", layout[f"layers.{i}.in_proj.w"], tp)
        layer.out_proj.tp = TPLinear.of("row", layout[f"layers.{i}.out_proj.w"], tp)
        layer.tp, layer.heads = tp, heads
    if model.shared_attn is not None:
        _mark_block(model.shared_attn, "shared_attn.", layout, tp)
    model.tp, model.tp_layout = tp, layout
    model.seq_shard = seq_shard and tp.size > 1
    return model


_KV = (".xattn.wk.", ".xattn.wv.")


def partial_grads(model) -> set[str]:
    """The parameters whose gradients a sequence-parallel model's last
    loss left partial on each rank (from its own tokens), to be summed over
    the model group: those replicated over ``model`` that ran on a split
    sequence (``model.seq_split``: the decoder's and the encoder's, of the
    last call), except an MoE's router and replicated expert stacks (the
    routed experts run whole on every rank, their gradient whole:
    :mod:`repro_torch.models.moe`) and a cross attention's replicated
    ``wk``/``wv`` over an encoder kept whole (their K/V's gradient summed
    over the group).  Empty without sequence parallelism."""
    split = getattr(model, "seq_split", None)
    if not getattr(model, "seq_shard", False) or not split:
        return set()
    layout = model.tp_layout
    encdec = model.cfg.family == "encdec"
    out = set()
    for name, _ in model.named_parameters():
        if name in layout or ".moe.w_" in name or ".moe.router." in name:
            continue
        enc = name.startswith("enc_layers.") or (encdec and name.startswith("frontend_proj."))
        if not split["enc" if enc else "dec"]:
            continue
        if any(k in name for k in _KV) and not split["enc"]:
            continue
        out.add(name)
    return out


# ---------------------------------------------------------------------------
# the vocab-parallel loss
# ---------------------------------------------------------------------------
def vocab_parallel_ce(logits: torch.Tensor, targets: torch.Tensor, start: int,
                      tp: TensorParallel) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logsumexp, target logit)`` over the whole vocabulary from this
    rank's fp32 logits of ``[start, start + V_r)``: the max all-reduced
    (MAX), the sum of exps and the target logit (from the rank that holds
    it, zeros elsewhere) all-reduced (SUM)."""
    v = logits.shape[-1]
    m = all_reduce_max(logits.amax(dim=-1), tp)
    sumexp = reduce_from_tp(torch.exp(logits - m[..., None]).sum(dim=-1), tp)
    mine = (targets >= start) & (targets < start + v)
    local = torch.gather(logits, -1, (targets - start).clamp(0, v - 1)[..., None].long())[..., 0]
    ll = reduce_from_tp(torch.where(mine, local, torch.zeros_like(local)), tp)
    return m + torch.log(sumexp), ll
