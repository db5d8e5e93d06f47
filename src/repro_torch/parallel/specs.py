"""Parameter, batch and cache layouts on a mesh.

The port of the JAX package's ``parallel/specs.py``.  Every parameter is
mapped to logical axes by its name, then bound to mesh axes through
:mod:`repro_torch.parallel.sharding`'s rules, dropping any axis whose
size does not divide the dim (GQA kv-head counts and the like stay
replicated rather than erroring) or that the mesh lacks.

The layout is JAX's 2-D "FSDP x TP" scheme: parameters shard over
``data`` (FSDP) and ``model`` (TP/EP); the ``pod`` axis is pure data
parallelism: parameters are **replicated across pods**, so the only
cross-pod traffic is the gradient all-reduce.

The rules are JAX's, rewritten over the port's parameter names (the names
:func:`repro_torch.convert.lm_params_from_jax` gives: ``layers.3.attn.wq.w``
for JAX's ``['layers']['attn']['wq']['w']``).  The port holds its layers
per module, not stacked, so JAX's leading ``stage`` axis of a stacked leaf
has no counterpart: the logical axes align to the trailing dims in both.
"""
from __future__ import annotations

from collections.abc import Mapping

import torch

from .sharding import DEFAULT_RULES, AxisRules, PartitionSpec, axis_sizes

__all__ = ["batch_shardings", "cache_shardings", "logical_axes_for", "param_shardings",
           "spec_for"]

# (name substring, logical axes of the trailing dims): the first match wins.
_RULES: tuple[tuple[str, tuple[str | None, ...]], ...] = (
    ("emb", ("vocab", "fsdp")),
    ("lm_head", ("vocab", "fsdp")),
    ("frontend_proj", (None, "fsdp")),
    ("router", ("fsdp", None)),
    # MoE expert stacks (E, d, f) / (E, f, d)
    ("moe.w_gate", ("expert", "fsdp", None)),
    ("moe.w_up", ("expert", "fsdp", None)),
    ("moe.w_down", ("expert", None, "fsdp")),
    ("wq.b", ("heads",)),
    ("wk.b", ("kv_heads",)),
    ("wv.b", ("kv_heads",)),
    ("wo.b", ("fsdp",)),
    ("wq", ("fsdp", "heads")),
    ("wk", ("fsdp", "kv_heads")),
    ("wv", ("fsdp", "kv_heads")),
    ("wo", ("heads", "fsdp")),
    ("w_gate", ("fsdp", "mlp")),
    ("w_up", ("fsdp", "mlp")),
    ("w_down", ("mlp", "fsdp")),
    ("in_proj", ("fsdp", "mlp")),
    ("out_proj", ("mlp", "fsdp")),
    ("conv_w", ("mlp", None)),
    ("conv_b", ("mlp",)),
    ("A_log", (None,)),
    ("dt_bias", (None,)),
)


def logical_axes_for(name: str, ndim: int) -> tuple[str | None, ...]:
    """The logical axes of parameter ``name`` with ``ndim`` dims: the first
    rule whose substring is in the name, aligned to the trailing dims
    (leading extra dims: ``stage``, then None); no rule: replicated."""
    for sub, axes in _RULES:
        if sub in name:
            n = len(axes)
            if ndim >= n:
                lead = ("stage",) + (None,) * (ndim - n - 1) if ndim > n else ()
                return tuple(lead) + axes
            return axes[-ndim:] if ndim else ()
    return (None,) * ndim  # norms, scalars, biases without rules: replicated


def _bind(mesh, rules: AxisRules, logical, shape) -> PartitionSpec:
    """JAX's binding: an entry is dropped where its axes' size is 1 or does
    not divide the dim, and axes the mesh lacks are pruned."""
    sizes = axis_sizes(mesh)
    names = mesh.mesh_dim_names
    entries = []
    for dim, lname in zip(shape, logical):
        e = rules.get(lname) if lname else None
        size = 1
        for a in () if e is None else (e,) if isinstance(e, str) else e:
            size *= sizes.get(a, 1)
        if e is None or size <= 1 or dim % size != 0:
            entries.append(None)
        elif isinstance(e, tuple):
            entries.append(tuple(a for a in e if a in names) or None)
        else:
            entries.append(e if e in names else None)
    return PartitionSpec(*entries)


def spec_for(name: str, shape, mesh, rules: AxisRules = DEFAULT_RULES) -> PartitionSpec:
    """The spec of parameter ``name`` of ``shape`` on ``mesh``."""
    return _bind(mesh, rules, logical_axes_for(name, len(shape)), tuple(shape))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()


def param_shardings(state_dict: Mapping, mesh,
                    rules: AxisRules = DEFAULT_RULES) -> dict[str, PartitionSpec]:
    """``{name: spec}`` of every tensor of ``state_dict`` (a model's, or
    :func:`repro_torch.launch.specs.abstract_params`' on the meta device)."""
    return {name: spec_for(name, _shape(t), mesh, rules) for name, t in state_dict.items()}


# ---------------------------------------------------------------------------
# input / cache shardings
# ---------------------------------------------------------------------------
_BATCH_AXES = {
    "tokens": ("batch", None),
    "frontend_emb": ("batch", None, None),
    "src_emb": ("batch", None, None),
    "image": ("batch", None, None, None),
    "label": ("batch",),
}

_CACHE_AXES = {
    "k": ("stage", "batch", "cache_seq", None, None),
    "v": ("stage", "batch", "cache_seq", None, None),
    "xk": ("stage", "batch", "cache_seq", None, None),
    "xv": ("stage", "batch", "cache_seq", None, None),
    "ak": ("stage", "batch", "cache_seq", None, None),
    "av": ("stage", "batch", "cache_seq", None, None),
    "conv": ("stage", "batch", None, "mlp"),
    "ssm": ("stage", "batch", "heads", None, None),
    "pos": (),
}


def batch_shardings(batch: Mapping, mesh, rules: AxisRules = DEFAULT_RULES
                    ) -> dict[str, PartitionSpec]:
    """``{name: spec}`` of a batch's tensors: the batch dim over the data
    axes, the rest replicated."""
    out = {}
    for name, t in batch.items():
        shape = _shape(t)
        logical = _BATCH_AXES.get(name, ("batch",) + (None,) * (len(shape) - 1))
        out[name] = _bind(mesh, rules, logical, shape)
    return out


def cache_shardings(cache: Mapping, mesh, rules: AxisRules = DEFAULT_RULES
                    ) -> dict[str, PartitionSpec]:
    """``{name: spec}`` of a decode cache's tensors (the stacked (L, B, ...)
    layout of :func:`repro_torch.models.lm.cache_spec`; ``pos``, an int,
    gets the empty spec)."""
    out = {}
    for name, t in cache.items():
        shape = _shape(t)
        out[name] = _bind(mesh, rules, _CACHE_AXES.get(name, (None,) * len(shape)), shape)
    return out
