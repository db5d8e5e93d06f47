"""Numerics legality lint for the port's ``QuantConfig``/``EMFormat`` pairs.

Static checks that a quantization configuration runs *exactly* on the
arithmetic the kernels assume:

* **Accumulator exactness.**  K3 and K4 sum a scaling group's integer
  products in int32 and convert the sum to fp32, exact only below 2^24:
  ``product_bits + ceil(log2(k_block)) < 24``.
* **Code width.**  Packed codes (sign, exponent, mantissa) must fit a
  byte: ``1 + E + M <= 8``.
* **Tiling.**  K3 contracts each scaling group in ``kKStep``-wide (16)
  tensor-core k steps and stages its codes with 16-byte ``cp.async``
  copies (``csrc/mls_matmul.cu``); a ``k_block`` that is not a multiple of
  ``kKStep`` leaves the last step of every group part empty and stages the
  codes with plain loads.  The kernels take any ``k_block``, so this is a
  warning.  The JAX package's rule here (a power of two in [16, 512] for
  the Pallas contraction tile) does not apply to the port.
* **Grouping and group-scale format.**  The grouping must name a known
  layout; the group-scale fraction must stay within the shift-add budget of
  the inter-group combine (``Mg <= 2``).
* **Wire fields** (the JAX package's checks): ``shard_ways >= 1``,
  ``wire_fsdp_dim`` in {None, 0, 1}, and a warning for ``packed_wire``
  without ``wire_fsdp_dim``.

* **Tensor parallelism** (:func:`lint_tensor_parallel`): an LM config of
  a ported family with grouping "nc" trains under any model axis
  (``parallel.tensor.tp_layout``): every split keeps its backend's
  scaling groups and whole heads, and what cannot split stays replicated,
  each case a warning that names it: query heads split unevenly in whole
  units, kv heads kept replicated, an attention with fewer units than
  ranks kept whole, a vocabulary the axis does not divide kept whole, the
  experts a rank (or the stacks kept replicated).  With ``seq_shard``
  (sequence parallelism) it also names a sequence that stays whole (the
  axis does not divide it, or a rank's slice is not whole scaling groups
  where a token slice is quantized on K1/K3) and what runs on each rank's
  own tokens: an attention kept whole, replicated kv linears, a
  vocabulary kept whole.

* **FSDP wire formats** (:func:`lint_wire`): under ``packed_wire`` every
  pinned linear's weight must move as packed codes over the data axis
  (``parallel.fsdp_wire``): a data slice that is neither whole scaling
  groups nor one part of a group spanning the dim is an error; a wire dim
  the data axis does not divide (its master gathered, as JAX leaves it
  unpinned) and ``packed_wire`` on the "pallas" backend (which ignores
  it, as JAX's does) are warnings.

Pure Python on dataclass fields: it runs on any host.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.formats import EMFormat, accumulation_bits
from repro_torch.core.lowbit import GROUPINGS, QuantConfig
from repro_torch.kernels.mls_matmul import TILE

__all__ = [
    "LintResult",
    "check_format_pair",
    "lint_quant_config",
    "lint_shipped_presets",
    "lint_tensor_parallel",
    "lint_wire",
]


@dataclasses.dataclass
class LintResult:
    errors: list[str]
    warnings: list[str]

    @property
    def ok(self) -> bool:
        return not self.errors

    def to_json(self) -> dict:
        return {"ok": self.ok, "errors": self.errors, "warnings": self.warnings}


def check_format_pair(fmt: EMFormat, k_block: int) -> list[str]:
    """Errors for an element format x accumulation depth pair."""
    errors = []
    if k_block < 1:
        errors.append(f"k_block must be >= 1, got {k_block}")
        return errors
    acc = accumulation_bits(fmt, k_block)
    if acc >= 24:
        errors.append(
            f"accumulating {k_block} products of {fmt} values needs {acc} "
            f"integer bits (product_bits={fmt.product_bits} + "
            f"ceil(log2(k_block))) >= 24: fp32 accumulation is no longer "
            f"bit-exact — shrink k_block or the ⟨E,M⟩ format"
        )
    if fmt.element_bits > 8:
        errors.append(
            f"{fmt} needs {fmt.element_bits} storage bits per element; the "
            f"packed code layout (sign|exp|man) is uint8 — max 8"
        )
    return errors


def lint_quant_config(cfg: QuantConfig) -> LintResult:
    """Full legality lint of one ``QuantConfig``."""
    errors = list(check_format_pair(cfg.fmt, cfg.k_block))
    warnings: list[str] = []

    margin = 24 - accumulation_bits(cfg.fmt, cfg.k_block)
    if 0 < margin <= 1:
        warnings.append(
            f"only {margin} bit of fp32 accumulator headroom for "
            f"{cfg.fmt} × k_block={cfg.k_block}; a 2x deeper group would "
            f"break exactness"
        )

    if cfg.grouping not in GROUPINGS:
        errors.append(
            f"unknown grouping {cfg.grouping!r}; expected one of "
            f"{GROUPINGS}"
        )

    if cfg.gs_fmt.m > 2:
        errors.append(
            f"group-scale format {cfg.gs_fmt} has Mg={cfg.gs_fmt.m} > 2: the "
            f"inter-group combine budgets <= 3 shifted adds per scale "
            f"(paper Sec. V-B); use Mg in {{0, 1, 2}}"
        )
    if cfg.gs_fmt.e < 4:
        warnings.append(
            f"group-scale format {cfg.gs_fmt} spans scale ratios only down "
            f"to 2^{cfg.gs_fmt.e_min}; groups quieter than that underflow to "
            f"the denormal level"
        )

    ks = TILE["kKStep"]
    if cfg.k_block % ks:
        steps = -(-cfg.k_block // ks)
        warnings.append(
            f"k_block={cfg.k_block} is not a multiple of K3's {ks}-wide k step: each "
            f"scaling group runs {steps} steps with {steps * ks - cfg.k_block} of "
            f"{steps * ks} slots empty, and its codes are staged without cp.async"
        )

    if cfg.shard_ways < 1:
        errors.append(f"shard_ways must be >= 1, got {cfg.shard_ways}")
    if cfg.wire_fsdp_dim not in (None, 0, 1):
        errors.append(f"wire_fsdp_dim must be None, 0 or 1, got {cfg.wire_fsdp_dim}")
    if cfg.packed_wire and cfg.wire_fsdp_dim is None:
        warnings.append("packed_wire=True without wire_fsdp_dim: codes are packed but not "
                        "pinned to the FSDP shard axis, so the gather may still move fp32")

    return LintResult(errors, warnings)


def lint_shipped_presets() -> dict[str, LintResult]:
    """Lint every QuantConfig the port's trainer ships
    (``python -m repro_torch.train --fmt ...``, :func:`train.loop.preset`)."""
    from repro_torch.train.loop import DEFAULT_FMTS, parse_fmt, preset

    return {f"train:mls{parse_fmt(s)}": lint_quant_config(preset(parse_fmt(s)))
            for s in DEFAULT_FMTS}


def lint_tensor_parallel(cfg, model_axis: int, seq_shard: bool = False,
                         seq_len: int | None = None) -> LintResult:
    """Whether the LM config ``cfg`` trains tensor-parallel over a model
    axis of ``model_axis`` (the module docstring): errors on a family not
    ported, on grouping other than "nc" and on a hidden dim with fewer
    scaling groups than ranks; warnings name the query heads split
    unevenly, the kv heads, attention or vocabulary kept replicated, the
    Mamba2 tail held by one rank, the experts a rank (or the expert stacks
    kept replicated) and the other dims split unevenly (in whole groups or
    units).  ``seq_shard``: under sequence parallelism, also what runs on
    each rank's own tokens and, given ``seq_len``, a sequence of that
    length that stays whole (the module docstring)."""
    from repro_torch.launch.specs import abstract_params
    from repro_torch.parallel.tensor import (
        TAIL_RANK, attention_heads, mamba_heads, rank_heads, tp_layout)

    errors: list[str] = []
    warnings: list[str] = []
    try:
        layout = tp_layout(cfg, {k: tuple(t.shape) for k, t in abstract_params(cfg).items()},
                           model_axis)
    except (NotImplementedError, ValueError) as e:
        return LintResult([str(e)], warnings)
    heads = attention_heads(cfg, model_axis) if model_axis > 1 and cfg.n_heads else None
    if model_axis > 1 and cfg.n_heads and heads is None:
        warnings.append(f"attention heads of {cfg.hd} do not split in whole scaling groups "
                        f"over {model_axis} ranks: the attention stays replicated")
    if heads is not None:
        sizes = {h1 - h0 for h0, h1 in heads}
        if len(sizes) > 1:
            warnings.append(f"query heads split unevenly in whole units: {max(sizes)} / "
                            f"{min(sizes)}")
        if rank_heads(cfg, model_axis, 0)[2] is not None:
            warnings.append(f"{cfg.n_kv_heads} kv heads stay replicated over a model axis of "
                            f"{model_axis}")
    if model_axis > 1 and "emb" not in layout:
        warnings.append(f"a vocabulary of {cfg.vocab} stays replicated over a model axis of "
                        f"{model_axis}")
    mamba = model_axis > 1 and cfg.family in ("ssm", "hybrid")
    if mamba:
        sp = layout["layers.0.in_proj.w"]
        a, b = sp.pieces[TAIL_RANK][-1]
        warnings.append(f"rank {TAIL_RANK} holds each Mamba2 in_proj's tail [{a}, {b}) (B, C "
                        f"and dt: {b - a} columns) and its conv channels, and broadcasts it")
        units = {h1 - h0 for h0, h1 in mamba_heads(cfg, model_axis)}
        if len(units) > 1:
            warnings.append(f"Mamba2 heads split unevenly in whole units: "
                            f"{max(units)} / {min(units)}")
    if model_axis > 1 and cfg.family == "moe":
        e = cfg.n_experts
        if "layers.0.moe.w_gate" in layout:
            warnings.append(f"{e // model_axis} of {e} experts a rank; each MoE layer gathers "
                            f"their outputs over the model group (an all-reduce of the whole "
                            f"(E, B*cap, d) buffer each way)")
        else:
            warnings.append(f"{e} experts do not split over a model axis of {model_axis}: the "
                            f"expert stacks stay replicated, every rank runs them all")
    # a Mamba2 layer's parts differ by the tail, and query heads by whole
    # units: both are warned of above
    grouped = {k: sp for k, sp in layout.items()
               if not (mamba and k.startswith("layers."))
               and not k.endswith(("wq.w", "wq.b", "wo.w"))}
    uneven = sorted({f"{name.split('.')[-2]} {sp.size(0)} / {sp.size(len(sp.pieces) - 1)}"
                     for name, sp in grouped.items()
                     if len({sp.size(r) for r in range(len(sp.pieces))}) > 1})
    if uneven:
        warnings.append(f"split unevenly in whole scaling groups: {uneven}")
    if seq_shard and model_axis > 1:
        warnings += _seq_warnings(cfg, model_axis, layout, heads, seq_len)
    return LintResult(errors, warnings)


def lint_wire(cfg, data: int) -> LintResult:
    """Whether FSDP over ``data`` ranks moves the LM config ``cfg``'s pinned
    weights as packed codes under ``packed_wire`` (the module docstring);
    empty without ``packed_wire``."""
    from repro_torch.launch.specs import abstract_params
    from repro_torch.parallel.fsdp_wire import wire_plan

    if not cfg.packed_wire:
        return LintResult([], [])
    warnings: list[str] = []
    qcfg = cfg.qcfg()
    if qcfg is not None and qcfg.backend != "fake_quant":
        warnings.append("packed_wire on the 'pallas' backend: its GEMMs code their operands "
                        "themselves and FSDP2 gathers the master weights, as the JAX "
                        "package's ignores wire there")
    _, kept, errors = wire_plan(cfg, {k: tuple(t.shape) for k, t in abstract_params(cfg).items()},
                                data)
    if kept:
        warnings.append(f"{len(kept)} pinned weights have a wire dim {data} data ranks do not "
                        f"divide: FSDP2 gathers their masters (e.g. {kept[0]})")
    return LintResult(errors, warnings)


def _seq_warnings(cfg, model_axis: int, layout, heads, seq_len: int | None) -> list[str]:
    """:func:`lint_tensor_parallel`'s warnings of sequence parallelism."""
    from repro_torch.parallel.tensor import TensorParallel, rank_heads, seq_unit, split_seq

    out = []
    if cfg.n_heads and heads is None:
        out.append("the whole attention runs wq, wk, wv and wo on each rank's own tokens, "
                   "K and V gathered along the sequence")
    elif cfg.n_heads and rank_heads(cfg, model_axis, 0)[2] is not None:
        out.append("the replicated kv linears run on each rank's own tokens, K and V gathered "
                   "along the sequence")
    if "emb" not in layout:
        out.append("the whole vocabulary's head and loss run on each rank's own tokens, the "
                   "loss's token sums all-reduced")
    unit = seq_unit(cfg, model_axis)
    if seq_len is not None and split_seq(TensorParallel(0, model_axis), seq_len, unit) is None:
        why = (f"{model_axis} does not divide it" if seq_len % model_axis else
               f"a rank's {seq_len // model_axis} positions are not whole scaling groups of "
               f"{unit}")
        out.append(f"a sequence of {seq_len} stays whole over a model axis of {model_axis} "
                   f"({why}): that call runs the DEFAULT layout")
    return out
