"""Multi-pod dry run: every (arch x shape x mesh) cell on the production
meshes, traced on fake tensors under a fake process group.

The port of the JAX package's ``launch/dryrun.py``.  Where JAX lowers and
compiles a cell for 256 or 512 TPU chips and reads XLA's analyses, the
port runs one step of the cell as rank 0 of a ``"fake"`` process group of
256 or 512 ranks (``torch.testing._internal.distributed.fake_pg``:
collectives return at once and move nothing), on fake tensors
(``FakeTensorMode``: shapes, dtypes and devices, no data, no memory), in
the launcher's own layout: tensor parallelism over ``model`` and FSDP2
over ("pod", "data") (``launch.train.shard_model``), the microbatches of
``choose_microbatch`` and rank 0's slice of the batch.  A train cell runs
``make_train_step``'s step; a serve cell (JAX's ``make_prefill_step`` and
``make_serve_step``) runs ``lm.prefill`` of ``max(1, B // dp)`` prompts
of ``seq_len`` tokens into a cache of ``seq_len`` (the encoder-decoder's
over as many source frames), or ``lm.decode_step`` of one token a row
against a full cache of ``seq_len`` (the encoder-decoder's cross cache
over ``SRC_LEN_DECODE`` frames), the rank's part of the cache
(``lm.cache_spec(..., tp=...)``: its kv heads, not JAX's ``cache_seq``
over ``model``).  Rank 0 holds the
largest shard under the port's splits (the first ranks take the extra
scaling groups; the Mamba2 tail sits on rank 0).  K1 and K3 take their
shape-only path on fake operands (``kernels.launch.shape_only``).

For each cell the record (``experiments/torch_dryrun/``) holds, on rank 0:

* ``memory_analysis``: ``argument_bytes`` (parameters, optimizer state
  and batch; serving: parameters, batch and, decoding, the cache, which
  JAX donates), ``output_bytes`` (parameters, optimizer state and metrics
  after the step; serving: the logits and the cache), ``temp_bytes`` (the
  peak less the arguments);
* serve cells: ``cache_bytes``, the rank's cache, beside
  ``cache_bytes_jax_layout``, JAX's per-device cache in closed form
  (``roofline.cache_bytes_jax_layout``); the roofline's memory term reads
  the rank's own;
  ``memory_by_kind`` at the peak, and ``peak_bytes`` / ``fits`` against
  the modelled card's memory (:mod:`.trace_counts` counts every storage);
* ``hlo``: dot FLOPs (total and by operand dtype) and collective wire
  bytes per device (by op, dtype and mesh dim), in the layout of JAX's
  HLO parse, ``"counted_by": "fake-tensor trace"`` (:mod:`.trace_counts`);
* ``roofline``: :func:`repro_torch.launch.roofline.roofline_terms` on
  those counts; ``launches`` by kernel entry; ``lower_s``, the trace's
  seconds (``compile_s`` null: nothing is compiled).

**The modelled card.**  A cell is planned for the card the committed tile
cache was tuned on (``kernels.autotune.modelled_card``, an H100 80GB
HBM3; its name is the record's ``modelled_device``), on a card and on the
CPU alike: K1's and K3's fake operands resolve their plans through that
cache (``kernels.launch.plan_for``), and ``fits`` compares the peak with
that card's memory (``roofline.HBM_BYTES``).  So a record does not depend
on the device that traced it.

**Depth and microbatches.**  Tracing costs about 0.15 ms of host time
per op whatever the shapes, and a full-depth cell runs up to 10^6 ops.
So a cell deeper than ``WHOLE_UP_TO`` depth
units is traced at 2 and 3 units, one with more microbatches at 2 and 3
microbatches (``POINTS``), and every count is carried to the cell's depth
and microbatch count: each depth unit adds the same ops (and, serving, the same cache
bytes), and each microbatch the same ops as the one before.  A depth unit is one layer
(dense, moe, ssm), one segment of ``attn_every`` Mamba2 layers with its
shared-block use (hybrid, the tail kept), or an encoder and a decoder
layer (encdec with equal stacks).  Counts are carried linearly in both;
the peak linearly in the depth at the last microbatch count traced, then
each further microbatch adds its input rows.  The points skip the first
unit and the first two microbatches, whose peaks are not on the line.
A stacked cache tensor's bytes are whole allocator blocks, which are
not linear in the depth: an extended serve cell's byte counts lie within
512 B per cache tensor of a whole trace's.  The record names its traces
(``hlo.traced``).  ``trace_cell(...,
extend=False)`` traces a cell whole: ``tests/test_torch_dryrun_extension.py``
holds the extension equal to it, exactly, for every family.

Cells whose layout ``analysis.lint.lint_tensor_parallel`` refuses are
recorded, not crashed on (``"refused"``, its message: a family not
ported, grouping other than "nc"), train and serve cells alike; every
production cell runs (what the model axis does not divide stays
replicated, ``parallel.tensor``), and whether it fits is its trace's
result.

**Sequence parallelism.**  ``run_cell(..., seq_shard=True)`` binds the
port's ``SP_RULES`` as JAX's binds its own: the microbatch of
``choose_microbatch(..., seq_shard=True)`` and the layout of
``shard_model(..., seq_shard=True)`` (``parallel.tensor``: the residual
stream split over ``model``), recorded with ``"rules": "sp"`` (else
``"default"``); the lint names a sequence that stays whole.

**FSDP wire formats.**  ``run_cell(..., cfg_updates={"param_gather_dtype":
"bfloat16"})`` lays the layers out with FSDP2's bf16 gathers, and
``cfg_updates={"packed_wire": True}`` gathers each pinned fake-quant weight
as packed codes and compact group scales (``launch.train.shard_model``,
``parallel.fsdp_wire``), as JAX's dry run takes both as ``cfg_updates``;
the counter records each gather at its payload dtype (``all-gather:bf16``,
``all-gather:u8``).  ``analysis.lint.lint_wire`` refuses a pinned weight
that cannot move as codes.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-72b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both

It needs no card; on a card its fake tensors are ``cuda`` ones.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any

import torch

from repro_torch.configs import ARCHS, SHAPES, RunConfig, get_config, runnable_shapes
from repro_torch.configs import shape_model_config
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.kernels.autotune import modelled_card
from repro_torch.parallel import DEFAULT_RULES, SP_RULES, MeshShape

from . import roofline as rf
from .mesh import PRODUCTION_SHAPES, make_production_mesh
from .specs import SRC_LEN_DECODE, choose_microbatch
from .trace_counts import StepCounter, mesh_dims

__all__ = ["OUT_DIR", "depth_units", "run_cell", "trace_cell", "trace_serve", "trace_step"]

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments",
                       "torch_dryrun")


# ---------------------------------------------------------------------------
# depth units and the extension
# ---------------------------------------------------------------------------
def depth_units(cfg: ModelConfig) -> tuple[int, Any] | None:
    """``(units, at)``: the config's depth in units and ``at(k)``, the config
    at ``k`` units (module docstring); None when the depth does not split
    into units (an encoder-decoder with unequal stacks: traced whole)."""
    if cfg.family == "hybrid" and cfg.attn_every:
        p, r = cfg.attn_every, cfg.n_layers % cfg.attn_every
        return cfg.n_layers // p, lambda k: dataclasses.replace(cfg, n_layers=r + p * k)
    if cfg.family == "encdec":
        if cfg.enc_layers != cfg.n_layers:
            return None
        return cfg.n_layers, lambda k: dataclasses.replace(cfg, n_layers=k, enc_layers=k)
    return cfg.n_layers, lambda k: dataclasses.replace(cfg, n_layers=k)


def _weights(points: list[int], x: int) -> list[float]:
    """Lagrange weights of the line through ``points`` (one or two) at ``x``."""
    if len(points) == 1:
        return [1.0]
    a, b = points
    return [(b - x) / (b - a), (x - a) / (b - a)]


def _combine(values: list, weights: list[float]):
    """``sum(w * v)`` over numbers or (nested) dicts of numbers."""
    first = values[0]
    if isinstance(first, dict):
        keys = sorted({k for v in values for k in v})
        return {k: _combine([v.get(k, 0) for v in values], weights) for k in keys}
    out = sum(w * v for w, v in zip(weights, values))
    return int(round(out)) if all(isinstance(v, int) for v in values) else float(out)


def _extend(traces: dict[tuple[int, int], dict], units: int, parts: int) -> dict:
    """The cell's counts at ``units`` and ``parts`` from traces at one or
    two depths x one or two microbatch counts (module docstring; one: the
    cell's own)."""
    ks = sorted({k for k, _ in traces})
    ms = sorted({m for _, m in traces})
    wk, wm = _weights(ks, units), _weights(ms, parts)
    keys = [(k, m) for m in ms for k in ks]
    weights = [wk[ks.index(k)] * wm[ms.index(m)] for k, m in keys]
    out = {name: _combine([traces[key][name] for key in keys], weights)
           for name in ("hlo", "argument_bytes", "output_bytes", "launches", "inputs_bytes",
                        "cache_bytes")}
    # the peak: linear in the depth at the last microbatch count traced,
    # then each further microbatch adds its input rows
    last = ms[-1]
    at_last = [traces[(k, last)] for k in ks]
    peak = _combine([t["peak_by_kind"] for t in at_last], wk)
    step = 0
    if len(ms) == 2:
        step = (traces[(ks[0], ms[1])]["inputs_bytes"] - traces[(ks[0], ms[0])]["inputs_bytes"]) \
            // (ms[1] - ms[0])
    peak["Inputs"] = peak.get("Inputs", 0) + (parts - last) * step
    out["peak_by_kind"] = {k: v for k, v in peak.items() if v}
    out["peak_bytes"] = sum(out["peak_by_kind"].values())
    out["seconds"] = sum(t["seconds"] for t in traces.values())
    return out


# ---------------------------------------------------------------------------
# one traced step
# ---------------------------------------------------------------------------
def _fake_device() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def _batch(cfg: ModelConfig, rows: int, seq: int, device: str) -> dict[str, torch.Tensor]:
    """Rank 0's batch of ``rows`` sequences (under the active fake mode)."""
    out = {"tokens": torch.zeros((rows, seq), dtype=torch.int64, device=device)}
    if cfg.family == "encdec":
        out["src_emb"] = torch.zeros((rows, seq, cfg.frontend_dim), device=device)
    elif cfg.frontend != "none":
        out["frontend_emb"] = torch.zeros((rows, cfg.frontend_len, cfg.frontend_dim),
                                          device=device)
    return out


def _laid_out(cfg: ModelConfig, device: str, fake: bool, mesh, seq_shard: bool = False,
              fsdp: bool = True):
    """A model of ``cfg`` on ``device`` (under the active fake mode, or real
    from seed 0), laid out by ``shard_model`` over ``mesh`` where given
    (``seq_shard``: with sequence parallelism); ``fsdp=False``: by
    ``tensor_parallel`` over the mesh's ``model`` group alone (a world
    that is one model group, as a card's runs lay it out)."""
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import TensorParallel, tensor_parallel

    from .train import shard_model

    if fake:
        with torch.device(device):
            model = lm.LM(cfg)
    else:
        model = lm.init_lm(cfg, seed=0, device=device)
    if mesh is not None and fsdp:
        shard_model(model, mesh, seq_shard)
    elif mesh is not None:
        tp = TensorParallel(mesh.get_local_rank("model"), mesh.size(mesh.mesh_dim_names.index(
            "model")), mesh.get_group("model"))
        tensor_parallel(model, tp, seq_shard=seq_shard)
    return model


def _register_parameters(counter: StepCounter, model) -> None:
    from repro_torch.train.trainer import local_params

    counter.register(list(local_params(model).values()) + list(model.buffers()), "Parameter")


def trace_step(cfg: ModelConfig, rows: int, seq: int, microbatch: int, mesh=None,
               device: str | None = None, fake: bool = True, seq_shard: bool = False,
               fsdp: bool = True) -> dict[str, Any]:
    """One ``make_train_step`` step of a model of ``cfg`` on ``rows`` fake
    sequences of ``seq`` tokens in ``microbatch`` parts (0 or 1: one),
    counted by :class:`~.trace_counts.StepCounter`: ``{"hlo",
    "argument_bytes", "output_bytes", "inputs_bytes", "cache_bytes" (0),
    "peak_bytes", "peak_by_kind", "launches", "seconds"}``.  With ``mesh`` (a
    ``DeviceMesh`` over a fake process group) the model is laid out as the
    launcher lays it out (``shard_model``); without, unsharded, as one
    card trains it.  ``device``: the fake tensors' ("cuda" when a card is
    present, else "cpu").  ``fake=False`` runs the same step on real
    tensors (random weights, zero tokens), counted the same way.
    ``seq_shard``, ``fsdp``: the layout's (:func:`_laid_out`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import launch
    from repro_torch.train import make_train_step

    device = device or _fake_device()
    run = RunConfig(model=cfg, shape=ShapeConfig("dryrun", seq, rows, "train"),
                    microbatch=microbatch)
    train_step, opt_init = make_train_step(run)
    t0 = time.time()
    recorded0 = collections.Counter(launch.RECORDED)
    counter = StepCounter(mesh_dims(mesh) if mesh is not None else None)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        model = _laid_out(cfg, device, fake, mesh, seq_shard, fsdp)
        batch = _batch(cfg, rows, seq, device)
        with counter:
            _register_parameters(counter, model)
            counter.register(list(batch.values()), "Inputs")
            opt = opt_init(model)  # an argument of the step, as JAX's eval_shape(opt_init)
            counter.register([*opt.mu.values(), *opt.nu.values()], "Optstate")
            arguments = counter.current()
            inputs = counter.live["Inputs"]
            model, opt, metrics = train_step(model, opt, batch)
            outputs = counter.live["Parameter"] + counter.live["Optstate"] + sum(
                counter.storage_bytes(t) for t in metrics.values())
    return _counts(counter, recorded0, arguments, outputs, inputs, 0, t0)


def _counts(counter: StepCounter, recorded0, arguments: int, outputs: int, inputs: int,
            cache: int, t0: float) -> dict[str, Any]:
    from repro_torch.kernels import launch

    recorded = launch.RECORDED - recorded0
    launches: collections.Counter = collections.Counter()
    for key, n in recorded.items():
        launches[key[0]] += n
    return {"hlo": counter.hlo(recorded), "argument_bytes": arguments,
            "output_bytes": outputs, "inputs_bytes": inputs, "cache_bytes": cache,
            "peak_bytes": counter.peak, "peak_by_kind": dict(counter.peak_by_kind),
            "launches": dict(launches), "seconds": time.time() - t0}


def trace_serve(cfg: ModelConfig, rows: int, seq: int, kind: str, mesh=None,
                device: str | None = None, fake: bool = True,
                seq_shard: bool = False) -> dict[str, Any]:
    """One serving step of a model of ``cfg``, counted as :func:`trace_step`
    counts a train step: ``kind`` "prefill", ``lm.prefill`` of ``rows``
    prompts of ``seq`` tokens (the encoder-decoder's over ``seq`` source
    frames) into a new cache of ``seq`` positions; "decode",
    ``lm.decode_step`` of one token a row against a full cache of ``seq``
    positions (its last slot written; the encoder-decoder's cross K/V of
    ``SRC_LEN_DECODE`` frames), the cache an argument (kind ``"Cache"``).
    Laid out as :func:`trace_step` lays a model out (``seq_shard``: with
    sequence parallelism, which a decode step's one token leaves whole);
    ``cache_bytes``: the rank's cache, exactly."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import launch
    from repro_torch.models import lm

    if kind not in ("prefill", "decode"):
        raise ValueError(f"a serving step is a prefill or a decode, not {kind!r}")
    device = device or _fake_device()
    t0 = time.time()
    recorded0 = collections.Counter(launch.RECORDED)
    counter = StepCounter(mesh_dims(mesh) if mesh is not None else None)
    with FakeTensorMode() if fake else contextlib.nullcontext():
        model = _laid_out(cfg, device, fake, mesh, seq_shard)
        if kind == "prefill":
            batch, cache = _batch(cfg, rows, seq, device), {}
        else:
            batch = {"tokens": torch.zeros((rows, 1), dtype=torch.int64, device=device)}
            cache = lm.init_cache(cfg, rows, seq, device, SRC_LEN_DECODE, model.tp)
            cache["pos"] = seq - 1
        with counter:
            _register_parameters(counter, model)
            counter.register(list(batch.values()), "Inputs")
            tensors = [t for t in cache.values() if isinstance(t, torch.Tensor)]
            counter.register(tensors, "Cache")
            arguments = counter.current()
            inputs = counter.live["Inputs"]
            if kind == "prefill":
                logits, cache = lm.prefill(model, batch, seq)
            else:
                logits, cache = lm.decode_step(model, cache, batch["tokens"])
            tensors = [t for t in cache.values() if isinstance(t, torch.Tensor)]
            outputs = sum(counter.storage_bytes(t) for t in [logits, *tensors])
    cache_bytes = sum(t.numel() * t.element_size() for t in tensors)
    return _counts(counter, recorded0, arguments, outputs, inputs, cache_bytes, t0)


# The depth units and microbatch counts an extended dim is traced at: past
# the first unit and the first microbatch, whose peaks differ from the
# others' (the first layer reads the embedding; from the third microbatch
# on, the previous loss and the running sum are both alive).  A dim of at
# most WHOLE_UP_TO is traced whole, which costs no more.
POINTS = (2, 3)
WHOLE_UP_TO = sum(POINTS)


def trace_cell(cfg: ModelConfig, rows: int, seq: int, microbatch: int, mesh=None,
               extend: bool = True, device: str | None = None,
               kind: str = "train", seq_shard: bool = False) -> dict[str, Any]:
    """:func:`trace_step` (``kind`` "train") or :func:`trace_serve` ("prefill",
    "decode"; no microbatches) of the whole cell, or (``extend``) its
    counts carried from traces at ``POINTS`` depth units and microbatches
    (module docstring); ``traced``: the ``[n_layers, microbatches]`` of
    each trace, ``extended``: whether it was carried; ``seq_shard``: laid
    out with sequence parallelism."""
    parts = max(1, microbatch)
    if rows % parts:
        raise ValueError(f"microbatch {microbatch} does not divide {rows} rows")
    units, at = depth_units(cfg) or (0, None)
    ks = list(POINTS) if extend and at is not None and units > WHOLE_UP_TO else [units]
    ms = list(POINTS) if extend and parts > WHOLE_UP_TO else [parts]
    traces = {}
    for m in ms:
        for k in ks:
            c = cfg if k == units else at(k)
            if kind == "train":
                traces[(k, m)] = trace_step(c, rows // parts * m, seq, m if m > 1 else 0, mesh,
                                            device, seq_shard=seq_shard)
            else:
                traces[(k, m)] = trace_serve(c, rows, seq, kind, mesh, device,
                                             seq_shard=seq_shard)
            traces[(k, m)]["cfg"] = c
    out = _extend(traces, units, parts)
    out["traced"] = [[t["cfg"].n_layers, m] for (k, m), t in sorted(traces.items())]
    out["extended"] = len(traces) > 1
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(size: int):
    """A ``"fake"`` process group of ``size`` ranks with this process as
    rank 0, destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the dry run makes its own fake world: a process group is already "
                           "initialized in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool,
    rules=None,
    microbatch: int | None = None,
    tag: str = "",
    out_dir: str | None = None,
    verbose: bool = True,
    cfg_updates: dict[str, Any] | None = None,
    seq_shard: bool = False,
    device: str | None = None,
) -> dict[str, Any]:
    """Trace one cell; returns (and writes) its record (module docstring).

    ``cfg_updates``: ModelConfig field overrides.  ``rules``: the layout's
    rule table, ``DEFAULT_RULES`` (the launcher's) or ``SP_RULES``
    (sequence parallelism).  ``seq_shard``: bind ``SP_RULES`` where no
    rules are given, and size the microbatch as JAX does under them
    (module docstring).  ``device``: the fake tensors' (:func:`trace_step`)."""
    from repro_torch.analysis.lint import lint_tensor_parallel, lint_wire

    if seq_shard and rules is None:
        rules = SP_RULES
    rules = rules or DEFAULT_RULES
    if rules not in (DEFAULT_RULES, SP_RULES):
        raise NotImplementedError("the dry run lays a cell out by DEFAULT_RULES (the "
                                  "launcher's) or SP_RULES; other rule tables are not ported")
    sp = rules.get("seq") == "model"
    shape = SHAPES[shape_name]
    cfg = shape_model_config(get_config(arch), shape)
    if cfg_updates:
        cfg = dataclasses.replace(cfg, **cfg_updates)
    sizes, axes = PRODUCTION_SHAPES[multi_pod]
    mesh_shape = MeshShape(axes, sizes)
    n_dev = math.prod(sizes)
    record: dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": "x".join(map(str, sizes)),
        "n_devices": n_dev, "tag": tag, "rules": "sp" if sp else "default",
        "param_gather_dtype": cfg.param_gather_dtype, "packed_wire": cfg.packed_wire,
    }
    model_axis, data = dict(zip(axes, sizes))["model"], dict(zip(axes, sizes))["data"]
    lint = lint_tensor_parallel(cfg, model_axis, seq_shard=sp,
                                seq_len=shape.seq_len if shape.kind != "decode" else 1)
    wire = lint_wire(cfg, data)
    lint.errors += wire.errors
    lint.warnings += wire.warnings
    if not lint.ok:
        record.update(status="refused", reason="; ".join(lint.errors))
    else:
        mb = 0
        if shape.kind == "train":
            mb = (choose_microbatch(cfg, shape, mesh_shape, seq_shard) if microbatch is None
                  else microbatch)
            record["microbatch"] = mb
        dp = n_dev // model_axis
        rows = max(1, shape.global_batch // dp)
        device = device or _fake_device()
        with fake_world(n_dev):
            mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
            counts = trace_cell(cfg, rows, shape.seq_len, mb, mesh, device=device,
                                kind=shape.kind, seq_shard=sp)
        record.update(status="ran", rows=rows, lint_warnings=lint.warnings)
        _fill(record, counts, cfg, shape, mesh_shape)
    if verbose:
        _say(record)
    out_dir = out_dir or OUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    fname = f"{arch}_{shape_name}_{record['mesh']}{('_' + tag) if tag else ''}.json"
    with open(os.path.join(out_dir, fname), "w") as f:
        json.dump(record, f, indent=1)
    return record


def _fill(record: dict, counts: dict, cfg: ModelConfig, shape: ShapeConfig, mesh) -> None:
    """The record's analysis keys from a cell's counts (module docstring)."""
    peak = counts["peak_bytes"]
    record["memory_analysis"] = {
        "argument_bytes": counts["argument_bytes"],
        "output_bytes": counts["output_bytes"],
        "temp_bytes": peak - counts["argument_bytes"],
        "alias_bytes": None,
    }
    record["memory_by_kind"] = counts["peak_by_kind"]
    record["hlo"] = {**counts["hlo"], "counted_by": "fake-tensor trace",
                     "traced": counts["traced"], "extended": counts["extended"]}
    record["cost_analysis"] = {"flops_raw": counts["hlo"]["dot_flops"],
                               "bytes_accessed_raw": None}
    record["lower_s"] = round(counts["seconds"], 2)
    record["compile_s"] = None
    if shape.kind != "train":
        record["cache_bytes"] = counts["cache_bytes"]
        record["cache_bytes_jax_layout"] = rf.cache_bytes_jax_layout(cfg, shape, mesh)
    record["roofline"] = rf.roofline_terms(cfg, shape, mesh, record)
    record["peak_bytes"] = peak
    record["modelled_device"] = modelled_card()
    record["device_memory_bytes"] = rf.HBM_BYTES
    record["fits"] = peak <= rf.HBM_BYTES
    record["launches"] = counts["launches"]


def _say(record: dict) -> None:
    rules = " (sp)" if record.get("rules") == "sp" else ""
    head = (f"[dryrun] {record['arch']} x {record['shape']} x {record['mesh']}{record['tag']}"
            f"{rules}")
    if record["status"] != "ran":
        print(f"{head}: {record['status']}: {record['reason']}", flush=True)
        return
    r = record["roofline"]
    mb = f"mb {record['microbatch']}" if "microbatch" in record else (
        f"cache {record['cache_bytes'] / 2**30:.2f} GiB")
    print(f"{head}: trace {record['lower_s']}s, {mb}, peak "
          f"{record['peak_bytes'] / 2**30:.2f} GiB (fits {record['fits']}), "
          f"compute {r['compute_s']:.2e}s mem {r['memory_s']:.2e}s "
          f"coll {r['collective_s']:.2e}s -> {r['bottleneck']} "
          f"(roofline frac {r['roofline_fraction']:.2f}, util {r['model_flops_ratio']:.2f})",
          flush=True)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(arch, sh.name) for arch, cfg in ARCHS.items() for sh in runnable_shapes(cfg)]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    status: collections.Counter = collections.Counter()
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                status[run_cell(arch, shape, mp, out_dir=args.out)["status"]] += 1
            except Exception as e:  # noqa: BLE001 -- a failed cell is a bug
                traceback.print_exc()
                failures.append((arch, shape, mp, repr(e)))
    print(f"\n{status['ran']} ran, {status['refused']} refused, {len(failures)} failed, of "
          f"{len(cells) * len(meshes)} cells")
    for f in failures:
        print("  FAILED", f)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
