"""The 1-byte FSDP weight gather of the JAX package's ``packed_wire``.

In the JAX package, ``quantize_operand(..., wire=True)`` with
``cfg.packed_wire`` pins the FSDP gather of each pinned fake-quant weight
onto its packed uint8 codes and its compact fp32 group scales
(``parallel.sharding.wire_pin``): the linears a layer calls with
``wire=0`` (in-projections: ``wq``, ``wk``, ``wv``, ``w_up``, ``w_gate``,
Mamba2's ``in_proj``) or ``wire=1`` (out-projections: ``wo``, ``w_down``,
``out_proj``), where the data axis divides that dim.  FSDP2 gathers a
module's parameters before its forward, before any call site's rounding
key is known, so the port holds such a weight outside FSDP2's groups
(``fully_shard(..., ignored_params=...)``): a ``DTensor`` sharded on its
wire dim over ``data`` and replicated over ``pod`` (the JAX layout:
``fsdp -> data``), and :class:`WireShard` says so on its
``models.nn.Linear``.  At each call the data rank's slice is quantized as
the slice of the whole weight (``core.lowbit.quantize_operand``'s
``wire_shard``: the tensor scale's max all-reduced over the data group,
the group scales local or, where a group spans the split, its max over
the ranks, the rounding offsets drawn at the whole shape and sliced), and
the codes and scales are gathered, unpacked and broadcast: the unit values
of ``packed_wire=False`` bit for bit, moved at 1 B an element plus 4 B a
scaling group.

The weight's gradient takes the path of FSDP2's: the uses of the weight
inside one loss (:func:`wire_scope`: one gather proxy a weight, as FSDP2's
unsharded parameter) add up in the gather dtype, and the sum is cast to
fp32, reduce-scattered over ``data`` and all-reduced over ``pod``, each
with ``ReduceOp.AVG`` (FSDP2's order and scale for an fp32 reduction).
With ``param_gather_dtype="bfloat16"`` too, the slice is rounded to bf16
before it is coded, and each use's gradient to bf16 before the sum.

What this costs against FSDP2: the gather runs at the call, with no
prefetch to overlap it with the previous layer's compute, and a use keeps
the gathered unit values (fp32) for its backward; under remat "full" the
recompute gathers again, as FSDP2 does.  Only the fake-quant backend pins
a weight (the quantized backend moves codes on its own, as JAX's
``"pallas"`` path ignores ``wire``), and a weight whose data slice is not
whole scaling groups, nor one part of a group that spans the dim, cannot
move as codes: :func:`wire_plan` names it and ``launch.train.shard_model``
raises.  Under tensor parallelism the wire dim is the one the model axis
leaves whole, so the data slice composes with the model slice.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from collections.abc import Mapping
from typing import Any

import torch

from repro_torch.core.lowbit import Sharded

__all__ = ["WIRE_DIMS", "WireShard", "pin_weights", "wire_bytes", "wire_plan", "wire_scope"]

# the weight dim each pinned linear is gathered along (its ``wire=`` in the
# layers, the JAX package's transformer.py and mamba2.py)
WIRE_DIMS = {"wq": 0, "wk": 0, "wv": 0, "w_up": 0, "w_gate": 0, "in_proj": 0,
             "wo": 1, "w_down": 1, "out_proj": 1}
_STACKS = ("layers.", "enc_layers.", "shared_attn.")

_SCOPE: contextvars.ContextVar[dict | None] = contextvars.ContextVar("wire_scope",
                                                                    default=None)


@dataclasses.dataclass(eq=False)
class WireShard:
    """A weight held sharded over the data axis along ``dim`` (``param``, a
    ``DTensor``; ``shard``, this data rank's slice, over the data group)
    and gathered as packed codes at each call; ``pod``: the process group
    of its replicas (None: one pod); ``dtype``: the gather dtype the slice
    is rounded to before it is coded; ``full_shape``: the weight whole
    along ``dim`` (this model rank's slice along the other dim)."""

    param: torch.nn.Parameter
    dim: int
    shard: Sharded
    pod: Any
    dtype: torch.dtype
    full_shape: tuple[int, ...]

    def at(self, dim: int | None) -> WireShard:
        """This shard at a call site that pins ``dim`` (it must be ours)."""
        if dim != self.dim:
            raise ValueError(f"a weight sharded for its wire dim {self.dim} is called with "
                             f"wire={dim}")
        return self

    def local(self) -> torch.Tensor:
        """This rank's slice (detached), rounded to the gather dtype, in fp32."""
        v = self.param.to_local().detach()
        return v if self.dtype == v.dtype else v.to(self.dtype).float()

    def proxy(self) -> torch.Tensor:
        """The gathered weight as autograd sees it: a tensor of
        ``full_shape`` in the gather dtype that holds no values (the call
        gathers them) and whose gradient is reduce-scattered into
        ``param``'s; one per weight inside :func:`wire_scope`."""
        scope = _SCOPE.get()
        if scope is not None and self in scope:
            return scope[self]
        return _Proxy.apply(self.param.to_local(), self)


class _Proxy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, wire):
        ctx.wire = wire
        return local.new_zeros((), dtype=wire.dtype).expand(wire.full_shape)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.wire), None


def _reduce(g: torch.Tensor, wire: WireShard) -> torch.Tensor:
    """The whole weight's gradient ``g`` -> this rank's slice of its mean
    over the data and pod ranks, in fp32, as FSDP2 reduces: the ranks'
    slices laid out rank-major, one reduce-scatter over ``data``, one
    all-reduce over ``pod``, both ``AVG``."""
    import torch.distributed as dist

    n = dist.get_world_size(wire.shard.group)
    flat = torch.cat(g.float().chunk(n, dim=wire.dim), dim=0).reshape(-1)
    out = flat.new_empty(flat.numel() // n)
    dist.reduce_scatter_tensor(out, flat, op=dist.ReduceOp.AVG, group=wire.shard.group)
    if wire.pod is not None:
        dist.all_reduce(out, op=dist.ReduceOp.AVG, group=wire.pod)
    shape = list(wire.full_shape)
    shape[wire.dim] //= n
    return out.view(shape)


@contextlib.contextmanager
def wire_scope(model: torch.nn.Module):
    """One gather proxy for each weight of ``model`` held by a
    :class:`WireShard`, for the code inside (a loss): the uses of a weight
    there add their gradients before one reduce-scatter, as the uses of
    FSDP2's unsharded parameter do."""
    wires = [m.wire for m in model.modules() if getattr(m, "wire", None) is not None]
    if not wires:
        yield
        return
    token = _SCOPE.set({w: _Proxy.apply(w.param.to_local(), w) for w in wires})
    try:
        yield
    finally:
        _SCOPE.reset(token)


def _dim_split(name: str, shape, dim: int, data: int, qcfg) -> str | None:
    """Why the weight ``name`` of ``shape`` cannot move as codes sliced
    ``data`` ways along ``dim`` (None: it can): its slice must hold whole
    scaling groups, or be one part of a group that spans the dim."""
    full = tuple(shape)
    block = qcfg.matmul_specs((1, full[0]), full)[1].resolve(full)[dim]
    part = full[dim] // data
    if block == full[dim] or part % block == 0:
        return None
    return (f"{name}: a slice of {part} of its dim {dim} of {full[dim]} over {data} data "
            f"ranks is not whole {block}-wide scaling groups, so its packed codes cannot be "
            f"gathered (packed_wire)")


def wire_plan(cfg, shapes: Mapping[str, tuple[int, ...]], data: int
              ) -> tuple[dict[str, int], list[str], list[str]]:
    """Which weights of a model of ``cfg`` (``shapes``: its unsharded
    parameters' by name) FSDP over ``data`` ranks gathers as packed codes:
    ``(pinned {name: wire dim}, kept, errors)``; ``kept`` names the pinned
    linears whose wire dim ``data`` does not divide (FSDP2 gathers their
    masters, as JAX's ``wire_pin`` leaves them unpinned), ``errors`` those
    that cannot move as codes.  Empty unless ``cfg.packed_wire`` on the
    fake-quant backend over more than one data rank."""
    qcfg = cfg.qcfg()
    if not cfg.packed_wire or qcfg is None or qcfg.backend != "fake_quant" or data <= 1:
        return {}, [], []
    pinned, kept, errors = {}, [], []
    for name, shape in shapes.items():
        parts = name.split(".")
        if not name.startswith(_STACKS) or parts[-1] != "w" or parts[-2] not in WIRE_DIMS:
            continue
        dim = WIRE_DIMS[parts[-2]]
        if shape[dim] % data:
            kept.append(name)
            continue
        why = _dim_split(name, shape, dim, data, qcfg)
        if why is not None:
            errors.append(why)
        pinned[name] = dim
    return pinned, kept, errors


def pin_weights(model: torch.nn.Module, mesh, pinned: Mapping[str, int]) -> set:
    """Hold each weight of ``pinned`` (:func:`wire_plan`'s) as a ``DTensor``
    on ``mesh`` (the ("pod", "data") mesh FSDP2 shards over) sharded along
    its wire dim over ``data`` and replicated over ``pod``, this rank's
    slice of the tensor it holds (no collective), with a
    :class:`WireShard` on its linear.  Returns the new parameters (FSDP2's
    ``ignored_params``)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.configs.base import torch_dtype

    names = mesh.mesh_dim_names
    sizes = dict(zip(names, tuple(mesh.shape)))
    d, r = sizes["data"], mesh.get_local_rank("data")
    pod = mesh.get_group("pod") if sizes.get("pod", 1) > 1 else None
    dtype = torch_dtype(model.cfg.param_gather_dtype)
    modules = dict(model.named_modules())
    out = set()
    for name, dim in pinned.items():
        lin = modules[name.removesuffix(".w")]
        if lin.tp is not None and (1 if lin.tp.kind == "column" else 0) == dim:
            raise NotImplementedError(f"{name}: the model axis splits its wire dim {dim}")
        w = lin.w
        n = w.shape[dim] // d
        local = w.detach().narrow(dim, r * n, n).clone()
        place = tuple(Shard(dim) if a == "data" else Replicate() for a in names)
        lin.w = torch.nn.Parameter(DTensor.from_local(local, mesh, place, run_check=False),
                                   requires_grad=w.requires_grad)
        lin.wire = WireShard(lin.w, dim, Sharded(dim, ((r * n, (r + 1) * n),), w.shape[dim],
                                                 mesh.get_group("data")),
                             pod, dtype, tuple(w.shape))
        out.add(lin.w)
    return out


def wire_bytes(cfg, shapes: Mapping[str, tuple[int, ...]], data: int) -> dict[str, float]:
    """Closed form of what one use of each pinned weight (``wire_plan``)
    puts on the wire per device in its gather: ``{"codes", "scales"}``,
    ``(data - 1) / data`` of the whole weight's bytes at 1 B an element and
    of its group scales at 4 B a group, except a group that spans the
    split (its scale is on every rank already)."""
    pinned = wire_plan(cfg, shapes, data)[0]
    qcfg = cfg.qcfg()
    codes = scales = 0.0
    for name, dim in pinned.items():
        full = tuple(shapes[name])
        codes += full[0] * full[1]
        block = qcfg.matmul_specs((1, full[0]), full)[1].resolve(full)
        if block[dim] != full[dim]:
            scales += 4 * (full[0] // block[0]) * (full[1] // block[1])
    f = (data - 1) / data
    return {"codes": codes * f, "scales": scales * f}
