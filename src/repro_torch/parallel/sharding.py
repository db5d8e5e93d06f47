"""Logical-axis sharding: tensors are named by *logical* axes, and rules
bind those names to the axes of a device mesh.

The port of the JAX package's ``parallel/sharding.py``.  The logical axes
and both rule sets are JAX's:

    batch      — data-parallel batch dim            -> ("pod", "data")
    seq        — sequence (activation/SP sharding)  -> None
    embed      — residual stream d_model            -> None
    heads      — attention heads                    -> "model"
    kv_heads   — kv heads (GQA)                     -> "model" when divisible
    mlp        — FFN hidden                         -> "model"
    vocab      — vocabulary                         -> "model"
    expert     — MoE experts                        -> "model"
    fsdp       — parameter shard dim (FSDP)         -> "data"
    stage      — layer-stack dim                    -> None

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims,
or a :class:`MeshShape` (the names and sizes alone, for computing a layout
without a world of that size).  A spec is the port's own
:class:`PartitionSpec`: one entry per tensor dim, each a mesh-axis name, a
tuple of them, or ``None`` (replicated); :func:`placements` turns it into
DTensor ``Shard``/``Replicate`` placements.

:func:`shard` and :func:`wire_pin` are the identity when no rules are
bound, as in JAX.  On a ``DTensor`` they ``redistribute`` it to the layout
the rules give.  On a plain tensor they are the identity too: the models
of the port compute on per-rank local tensors (under FSDP2 each rank runs
the whole model on its slice of the batch, with the parameters gathered
by FSDP2's hooks), where a layout constraint has nothing to act on.  So
the models carry no ``shard`` calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

__all__ = [
    "DEFAULT_RULES",
    "SP_RULES",
    "AxisRules",
    "MeshShape",
    "PartitionSpec",
    "axis_rules",
    "axis_sizes",
    "current_rules",
    "logical_to_mesh",
    "placements",
    "shard",
    "shard_spec",
    "wire_pin",
]

_state = threading.local()


class PartitionSpec(tuple):
    """One entry per tensor dim: a mesh-axis name, a tuple of names (the
    dim split over those axes, major first), or ``None`` (replicated).  A
    tuple of one name is that name, as in JAX's ``PartitionSpec``."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple) and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, read the way a ``DeviceMesh`` is
    (``mesh_dim_names``, ``shape``): a layout can be computed for a mesh
    larger than the world at hand."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a :class:`MeshShape`."""
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("the mesh's dims have no names")
    return dict(zip(names, tuple(mesh.shape)))


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis (or a tuple of them, or None)."""

    rules: tuple[tuple[str, object | None], ...]

    def get(self, name: str):
        for k, v in self.rules:
            if k == name:
                return v
        return None

    def replace(self, **kw) -> AxisRules:
        d = dict(self.rules)
        d.update(kw)
        return AxisRules(tuple(d.items()))


DEFAULT_RULES = AxisRules(
    rules=(
        ("batch", ("pod", "data")),
        ("seq", None),
        ("embed", None),
        ("heads", "model"),
        ("kv_heads", "model"),
        ("mlp", "model"),
        ("vocab", "model"),
        ("expert", "model"),
        ("fsdp", "data"),
        ("stage", None),
        ("cache_seq", "model"),  # decode KV caches shard over TP
        ("kv_seq", None),  # attention K/V seq dim: gathered under SP
        ("moe_rows", ("pod", "data")),  # MoE dispatch row groups
    )
)

# Sequence parallelism: activations shard their sequence dim over the TP
# axis, and MoE dispatch rows over every axis.
SP_RULES = DEFAULT_RULES.replace(seq="model", moe_rows=("pod", "data", "model"))


def current_rules() -> AxisRules | None:
    return getattr(_state, "rules", None)


def _current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def axis_rules(rules: AxisRules, mesh=None):
    """Bind logical->mesh rules (and optionally a mesh) for the code inside."""
    prev = (current_rules(), _current_mesh())
    _state.rules, _state.mesh = rules, mesh
    try:
        yield
    finally:
        _state.rules, _state.mesh = prev


def _prune(mesh, spec_entry):
    """Drop mesh axes the mesh lacks (one rule set serves one pod and many)."""
    if spec_entry is None:
        return None
    names = mesh.mesh_dim_names
    if isinstance(spec_entry, str):
        return spec_entry if spec_entry in names else None
    pruned = tuple(a for a in spec_entry if a in names)
    return pruned if pruned else None


def logical_to_mesh(logical: tuple[str | None, ...], rules: AxisRules | None = None,
                    mesh=None) -> PartitionSpec:
    """The spec of logical axes under ``rules`` (default: the bound ones,
    else :data:`DEFAULT_RULES`), pruned to ``mesh``'s axes when one is
    given or bound."""
    rules = rules or current_rules() or DEFAULT_RULES
    mesh = mesh or _current_mesh()
    entries = []
    for name in logical:
        e = rules.get(name) if name is not None else None
        if mesh is not None:
            e = _prune(mesh, e)
        entries.append(e)
    return P(*entries)


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    sizes = axis_sizes(mesh)
    n = 1
    for a in (entry,) if isinstance(entry, str) else entry:
        n *= sizes.get(a, 1)
    return n


def shard_spec(shape, logical: tuple[str | None, ...], rules: AxisRules, mesh) -> PartitionSpec:
    """The spec :func:`shard` gives a tensor of ``shape``: the logical axes'
    entries, with a mesh axis already used by an earlier dim dropped (two
    logical axes may map to one mesh axis) and an entry dropped where the
    dim is smaller than its axes (JAX pads a dim that does not divide, at
    most 2x; replication would cost the whole axis)."""
    spec = logical_to_mesh(logical, rules, mesh)
    entries, used = [], set()
    for dim, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        if e is not None:
            names = tuple(n for n in ((e,) if isinstance(e, str) else tuple(e)) if n not in used)
            e = (names[0] if len(names) == 1 else names) if names else None
        if e is not None and dim < _axis_size(mesh, e):
            e = None
        if e is not None:
            used.update((e,) if isinstance(e, str) else e)
        entries.append(e)
    return P(*entries)


def placements(spec: PartitionSpec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dim, ``Shard(d)``
    of the tensor dim ``d`` whose entry names it, else ``Replicate()``.  A
    dim split over several axes must name them in the mesh's order (the
    order DTensor splits in)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh.mesh_dim_names
    owner: dict[str, int] = {}
    for d, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"dim {d} splits over {axes}, not in the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"mesh axis {a!r} shards dims {owner[a]} and {d}")
            owner[a] = d
    return tuple(Shard(owner[a]) if a in owner else Replicate() for a in names)


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """``x`` laid out by its logical axes: a ``DTensor`` is redistributed to
    :func:`shard_spec`'s placements on its own mesh; identity without bound
    rules or on a plain (per-rank local) tensor."""
    rules = current_rules()
    if rules is None or not _dtensor(x):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, placements(shard_spec(x.shape, logical, rules, mesh), mesh))


def wire_pin(x: torch.Tensor, fsdp_dim: int) -> torch.Tensor:
    """Make the FSDP gather of a weight happen on *this* tensor (its packed
    uint8 codes or its unit values): a ``DTensor`` is first sharded over the
    ``fsdp`` axes on ``fsdp_dim``, then gathered there (under sequence
    sharding, ``seq`` bound to a mesh axis, gathered on every dim).  The
    identity without bound rules and mesh, on a plain tensor, where the dim
    does not divide, or where the mesh lacks the ``fsdp`` axes."""
    rules, mesh = current_rules(), _current_mesh()
    if rules is None or mesh is None or not _dtensor(x):
        return x
    mesh = x.device_mesh
    ax = _prune(mesh, rules.get("fsdp"))
    if ax is None or x.ndim <= fsdp_dim or x.shape[fsdp_dim] % _axis_size(mesh, ax):
        return x
    from torch.distributed.tensor import Replicate, Shard

    axes = (ax,) if isinstance(ax, str) else ax
    names = mesh.mesh_dim_names
    sharded = tuple(Shard(fsdp_dim) if n in axes else p for n, p in zip(names, x.placements))
    x = x.redistribute(mesh, sharded)
    if _prune(mesh, rules.get("seq")) is not None:  # activations row-sharded: gather all
        return x.redistribute(mesh, (Replicate(),) * mesh.ndim)
    return x.redistribute(mesh, tuple(Replicate() if n in axes else p
                                      for n, p in zip(names, sharded)))
