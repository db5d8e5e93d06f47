"""What one traced step computes, moves and holds, counted op by op: the
role of the JAX package's HLO parse (``analysis/hlo_parser.py``) for a step
that PyTorch runs eagerly, on real tensors or on fake ones.

:class:`StepCounter` is a ``TorchDispatchMode``.  While it is active it
counts, on this rank:

* **dot FLOPs**: every op of ``torch.utils.flop_counter``'s registry (mm,
  addmm, bmm, baddbmm, convolutions, attention kernels) at its formula,
  bucketed by the dtype of its first operand (JAX's ``dot_flops_by_dtype``),
  plus K3's launches (:func:`kernel_dot_flops`: ``2 M N K`` over uint8 codes);
  a recompute under remat runs under the trace, so it is counted, as the
  JAX parse's trip-corrected count does;
* **collective wire bytes per device**, by op, by op and payload dtype,
  and by the mesh dim of the group, with JAX's ring conventions
  (:func:`wire_bytes`), for the c10d ops that FSDP2 and
  :mod:`repro_torch.parallel.tensor` emit and for the functional
  collectives;
* **memory**: the bytes of every storage alive, by kind, and their peak.
  A storage is counted from the op that makes it until Python frees it,
  in 512-byte blocks as the CUDA caching allocator hands them out;
  ``UntypedStorage.resize_`` (FSDP2 frees an unsharded parameter by
  resizing its storage to 0) is followed while the counter is active.
  Kinds are the ``torch.distributed._tools`` trackers' names: tensors
  the caller registers (``"Parameter"``, ``"Optstate"``, ``"Inputs"``,
  and a serving step's ``"Cache"``),
  FSDP2's all-gather outputs (``"All Gather"``), and what ops make
  outside a backward (``"Activation"``: the forward, the clip, the
  update) or inside one (``"Temp"``).  An op's own scratch, which no
  dispatched op shows, is ``"Workspace"`` while the op runs, for the ops
  whose CUDA implementation was seen to allocate more than 1% of a step's
  peak (:func:`workspace_bytes`).

DTensors are counted through their local tensors (the counter returns
``NotImplemented`` to them, as the trackers do), and ops that DTensor's
sharding propagation runs under a nested fake mode are not counted.
"""
from __future__ import annotations

import collections
import math
import weakref
from collections.abc import Iterable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["BLOCK", "KINDS", "StepCounter", "dtype_name", "kernel_dot_flops", "mesh_dims",
           "wire_bytes", "workspace_bytes"]

BLOCK = 512  # bytes: the CUDA caching allocator's rounding of a block
KINDS = ("Parameter", "Optstate", "Inputs", "Cache", "All Gather", "Activation", "Temp",
         "Workspace")


def _blocks(n: int) -> int:
    return math.ceil(n / BLOCK) * BLOCK


def workspace_bytes(func, args) -> int:
    """Scratch that ``func``'s CUDA implementation allocates and frees
    inside the op, beyond its outputs, as measured on an H100 (PyTorch
    2.x; the ``dryrun`` phase of ``chip_smoke.py`` holds the counter to the
    allocator): the softmax backward takes one buffer of its output's size,
    and one more for each operand (gradient, softmax output) that is not
    contiguous (the attention's scores: 4 and 8 GiB on zamba2-7b's and
    chatglm3-6b's at 2 x 4096); ``logsumexp`` one of its input's size (the
    loss's logits)."""
    aten = torch.ops.aten
    if func is aten._softmax_backward_data.default:
        copies = 1 + sum(not t.is_contiguous() for t in args[:2])
        return copies * _blocks(args[1].numel() * args[1].element_size())
    if func is aten.logsumexp.default:
        return _blocks(args[0].numel() * args[0].element_size())
    return 0


def wire_bytes(op: str, out_bytes: float, group: int) -> float:
    """Bytes one device puts on the wire for a collective whose output on
    it has ``out_bytes`` bytes, over ``group`` ranks (ring algorithms; the
    JAX package's ``hlo_parser`` conventions):

    all-gather ``out (g-1)/g``; all-reduce ``2 out (g-1)/g``;
    reduce-scatter ``out (g-1)`` (out: the local shard); all-to-all
    ``out (g-1)/g``; broadcast ``out`` (each receiver takes it whole once:
    JAX's collective-permute)."""
    g = group
    if g <= 1:
        return 0.0
    if op == "all-gather" or op == "all-to-all":
        return out_bytes * (g - 1) / g
    if op == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "broadcast":
        return float(out_bytes)
    raise ValueError(f"unknown collective {op!r}")


def kernel_dot_flops(recorded: collections.Counter) -> float:
    """``2 M N K`` over K3's recorded launches (``kernels.launch.RECORDED``
    entries of ``mls_matmul``: M, N, K padded to its groups), the dot FLOPs
    of the quantized-domain GEMMs, which no aten op carries."""
    return float(sum(2.0 * key[2] * key[3] * key[4] * n for key, n in recorded.items()
                     if key[0] == "mls_matmul"))


_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
_NOT_COLLECTIVES = ("wait_tensor", "barrier")


def _c10d_ops() -> dict:
    """op -> (collective, where its output lies in the arguments, group
    argument): the in-place c10d ops that FSDP2 and the tensor-parallel
    layers emit (their output tensor, or list of one, first) and the
    functional collectives (the op's result; the group by name, last).
    Any other op of these namespaces but a wait or a barrier raises in the
    counter: its bytes would go uncounted."""
    c10d, fn = torch.ops.c10d, torch.ops._c10d_functional
    return {c10d._allgather_base_.default: ("all-gather", 0, 2),
            c10d._reduce_scatter_base_.default: ("reduce-scatter", 0, 2),
            c10d.allreduce_.default: ("all-reduce", 0, 1),
            c10d.broadcast_.default: ("broadcast", 0, 1),
            fn.all_reduce.default: ("all-reduce", None, "name"),
            fn.all_gather_into_tensor.default: ("all-gather", None, "name"),
            fn.reduce_scatter_tensor.default: ("reduce-scatter", None, "name"),
            fn.broadcast.default: ("broadcast", None, "name"),
            fn.all_to_all_single.default: ("all-to-all", None, "name")}


_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
                torch.uint8: "u8", torch.int8: "s8", torch.int32: "s32", torch.int64: "s64",
                torch.float64: "f64", torch.bool: "pred"}


def dtype_name(dtype: torch.dtype) -> str:
    """XLA's short name of a dtype (``f32``, ``bf16``, ``u8``, ...), the
    JAX records' bucket keys."""
    return _DTYPE_NAMES.get(dtype, str(dtype).removeprefix("torch."))


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(st: torch.UntypedStorage) -> int:
    return _blocks(st.nbytes())


class StepCounter(TorchDispatchMode):
    """Dot FLOPs, wire bytes and live memory of the ops run under it (the
    module docstring).  ``dims``: process-group name -> mesh dim name
    (:func:`mesh_dims`), the keys of ``coll_by_dim``."""

    def __init__(self, dims: dict[str, str] | None = None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self._colls = _c10d_ops()
        self.dims = dict(dims or {})
        self.dot_flops_by_dtype: collections.Counter = collections.Counter()
        self.coll: collections.Counter = collections.Counter()
        self.coll_by_dim: collections.Counter = collections.Counter()
        self.coll_counts: collections.Counter = collections.Counter()
        self.live: collections.Counter = collections.Counter()  # kind -> bytes
        self.peak = 0
        self.peak_by_kind: dict[str, int] = {}
        self._storages: dict[int, list] = {}  # id(storage) -> [kind, bytes, weakref]
        self._fake_mode = None
        self._resize = None

    # ---- memory -----------------------------------------------------------
    def register(self, tensors: Iterable[torch.Tensor] | torch.Tensor, kind: str) -> None:
        """Count the storages of ``tensors`` (DTensors: their local shards)
        as ``kind``, moving any already counted under another kind."""
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; expected one of {KINDS}")
        for t in _tensors(tensors):
            self._track(t, kind, retag=True)
        self._update_peak()

    def current(self) -> int:
        """The bytes alive now."""
        return sum(self.live.values())

    @staticmethod
    def storage_bytes(t: torch.Tensor) -> int:
        """The bytes ``t``'s storage takes, in allocator blocks."""
        return _storage_bytes(t.untyped_storage())

    def _track(self, t: torch.Tensor, kind: str, retag: bool = False) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t.to_local()
        st = t.untyped_storage()
        entry = self._storages.get(id(st))
        if entry is not None:
            if retag and entry[0] != kind:
                self.live[entry[0]] -= entry[1]
                self.live[kind] += entry[1]
                entry[0] = kind
            return
        n = _storage_bytes(st)
        key = id(st)
        entry = [kind, n, weakref.ref(st, lambda _, key=key: self._free(key))]
        self._storages[key] = entry
        self.live[kind] += n

    def _free(self, key: int) -> None:
        entry = self._storages.pop(key, None)
        if entry is not None:
            self.live[entry[0]] -= entry[1]

    def _resized(self, st: torch.UntypedStorage) -> None:
        entry = self._storages.get(id(st))
        if entry is not None:
            n = _storage_bytes(st)
            self.live[entry[0]] += n - entry[1]
            entry[1] = n
            self._update_peak()

    def _update_peak(self, workspace: int = 0) -> None:
        now = self.current() + workspace
        if now > self.peak:
            self.peak = now
            self.peak_by_kind = {k: v for k, v in self.live.items() if v}
            if workspace:
                self.peak_by_kind["Workspace"] = workspace

    # ---- the mode ---------------------------------------------------------
    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake_mode = active_fake_mode()
        orig = torch.UntypedStorage.resize_
        self._resize = orig

        def resize_(st, size):
            out = orig(st, size)
            self._resized(st)
            return out

        torch.UntypedStorage.resize_ = resize_
        return super().__enter__()

    def __exit__(self, *args):
        torch.UntypedStorage.resize_ = self._resize
        return super().__exit__(*args)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode
        from torch.distributed.tensor import DTensor

        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_mode:  # DTensor's propagation
            return out
        packet = func._overloadpacket
        if packet in self._flops:
            x = next((a for a in args if isinstance(a, torch.Tensor)), None)
            flops = self._flops[packet](*args, **kwargs, out_val=out)
            self.dot_flops_by_dtype[dtype_name(x.dtype) if x is not None else "?"] += flops
        coll = self._colls.get(func)
        if coll is not None:
            self._count_collective(coll, args, out)
        elif (getattr(func, "namespace", None) in _COLLECTIVE_NAMESPACES
              and packet.__name__ not in _NOT_COLLECTIVES):
            raise NotImplementedError(f"the step counter has no wire formula for {func}")
        in_bw = torch._C._current_autograd_node() is not None
        kind = "All Gather" if coll is not None and coll[0] == "all-gather" else (
            "Temp" if in_bw else "Activation")
        for t in _tensors(out):
            self._track(t, kind, retag=kind == "All Gather")
        if coll is not None and coll[1] is not None:
            for t in _tensors(args[coll[1]]):
                self._track(t, kind, retag=kind == "All Gather")
        self._update_peak(workspace_bytes(func, args))
        return out

    def _count_collective(self, coll, args, out) -> None:
        op, where, group = coll
        tensors = _tensors(out if where is None else args[where])
        if not tensors:
            return
        if group == "name":  # functional: (..., group_size?, group_name) last
            name = args[-1]
            size = _group_size_by_name(name)
        else:
            pg = args[group]
            if isinstance(pg, torch.ScriptObject):
                pg = torch._C._distributed_c10d.ProcessGroup.unbox(pg)
            name, size = pg.group_name, pg.size()
        out_bytes = sum(t.numel() * t.element_size() for t in tensors)
        b = wire_bytes(op, out_bytes, size)
        dim = self.dims.get(name, "world" if size == _world() else f"group of {size}")
        self.coll[op] += b
        self.coll[f"{op}:{dtype_name(tensors[0].dtype)}"] += b
        self.coll_by_dim[dim] += b
        self.coll_counts[op] += 1

    # ---- results ----------------------------------------------------------
    def hlo(self, recorded: collections.Counter | None = None) -> dict:
        """The counts in the JAX package's ``analyze_hlo`` layout:
        ``dot_flops``, ``dot_flops_by_dtype``, ``coll_bytes``,
        ``coll_breakdown``, ``coll_counts``, and ``coll_by_dim``; with
        ``recorded`` (the launches of the step), K3's dot FLOPs under
        ``"u8"``."""
        by_dtype = collections.Counter(self.dot_flops_by_dtype)
        if recorded:
            k3 = kernel_dot_flops(recorded)
            if k3:
                by_dtype["u8"] += k3
        return {
            "dot_flops": float(sum(by_dtype.values())),
            "dot_flops_by_dtype": {k: float(v) for k, v in by_dtype.items()},
            "coll_bytes": float(sum(v for k, v in self.coll.items() if ":" not in k)),
            "coll_breakdown": {k: float(v) for k, v in self.coll.items()},
            "coll_counts": dict(self.coll_counts),
            "coll_by_dim": {k: float(v) for k, v in self.coll_by_dim.items()},
        }


def _world() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _group_size_by_name(name: str) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size()


def mesh_dims(mesh) -> dict[str, str]:
    """Process-group name -> dim name over a ``DeviceMesh``'s dims."""
    return {mesh.get_group(d).group_name: d for d in mesh.mesh_dim_names}
