"""LM training launcher.

    python -m repro_torch.launch.train --arch mamba2-370m --shape train_4k \\
        --steps 1000 --ckpt-dir ckpts/mamba2

builds the (optionally microbatched) train step of
:func:`repro_torch.train.make_train_step`, makes the model on the card
from the run's seed, and runs the loop with asynchronous checkpoints
(params, optimizer state and the data stream's position), resume from the
latest one, and straggler monitoring; it prints every 10 steps.  It runs
on CUDA unless ``--device cpu`` is given.  ``--smoke`` trains the arch's
reduced config (batch 8, seq 64 unless overridden), with no accumulation.

Under ``torchrun`` (``WORLD_SIZE`` set) it trains over the world:
``torchrun --nproc_per_node 8 -m repro_torch.launch.train --arch
chatglm3-6b [--multi-pod] [--model-axis 2]``.  The mesh is ``(pods, world
// (pods * N), N)`` over ("pod", "data", "model"), ``pods`` 2 under
``--multi-pod`` and 1 otherwise, ``N`` the ``--model-axis``.  With ``N`` >
1 each model group trains every family tensor-parallel
(:mod:`repro_torch.parallel.tensor`: Megatron-split linears, Mamba2
layers split by heads, MoE experts split whole with their outputs
gathered, column-parallel cross-attention K/V, a vocab-parallel
embedding, head and loss).  Then every layer and
the model are sharded with FSDP2 ``fully_shard`` over the 2-D ("pod",
"data") mesh (HSDP), each rank's
tensor-parallel parameters: sharded over ``data`` and replicated across
pods, the JAX package's layout (:mod:`repro_torch.parallel.specs`), each
on the dim :func:`fsdp_shard_dim` picks (dim 0, or JAX's ``fsdp`` dim where
dim 0 would pad: a rank's stack of fewer experts than data ranks).  Each
rank trains on its slice of the global batch, chosen by its ("pod",
"data") coordinate (all ranks of a model group take the same slice); the
gradient reduction averages over ("pod", "data").  The JAX launcher's mesh
is the fixed (2, 16, 16) of 512 TPU chips; the port sizes ``data`` from the
world instead.  The config's ``param_gather_dtype="bfloat16"`` and
``packed_wire`` choose FSDP's 2-byte and 1-byte weight gathers
(:func:`shard_model`), as in the JAX package (no flag: neither has one).
Checkpoints under torchrun hold each rank's shards, in
``rank<r>/`` of ``--ckpt-dir``.  ``--smoke`` with ``--model-axis``
widens the smoke config (:func:`tp_smoke`: the heads and MLP, the MoE's
expert width and the Mamba2 layers' din) so that the splits keep whole
scaling groups.  As in the JAX launcher, the data stream carries no
``src_emb``, so the encoder-decoder does not train here: drive it through
:func:`shard_model` and ``make_train_step`` on batches that carry it.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os

import torch

from repro_torch.configs import SHAPES, RunConfig, get_config, get_smoke_config
from repro_torch.configs import shape_model_config
from repro_torch.data import make_lm_iterator
from repro_torch.models import lm
from repro_torch.parallel.fsdp_wire import pin_weights, wire_plan
from repro_torch.parallel.sharding import MeshShape, axis_sizes
from repro_torch.parallel.specs import logical_axes_for
from repro_torch.parallel.tensor import TensorParallel, tensor_parallel
from repro_torch.runtime import resolve_device
from repro_torch.train import CheckpointManager, StragglerMonitor, make_train_step
from repro_torch.train.trainer import local_params

from .mesh import make_mesh
from .specs import choose_microbatch

__all__ = ["fsdp_shard_dim", "hsdp_mesh", "local_batch", "main", "shard_model", "tp_smoke"]

MESH_AXES = ("pod", "data", "model")
# The smoke configs' 16-wide heads and 96-wide d_ff keep no 128-wide scaling
# group whole on a rank: under --model-axis, --smoke trains them with
# 128-wide heads, chatglm3-6b's 2 kv heads and a d_ff of 5 groups (an odd
# count, split unevenly).
TP_SMOKE = dict(head_dim=128, n_kv_heads=2, d_ff=5 * 128)
# ... and their Mamba2 layers' din of 128 is one group: d_model 256 gives a
# din of 4 groups, 16 heads of 32 (the hybrid takes TP_SMOKE's attention too)
TP_SMOKE_SSM = dict(d_model=256, ssm_headdim=32)
# ... and an MoE's shared expert of d_ff moe_d_ff 64 is one group: 5 groups
# split whole at a model axis of 2 and 4 (the routed experts split whole)
TP_SMOKE_MOE = dict(moe_d_ff=5 * 128)


def tp_smoke(cfg):
    """A smoke config widened for a model axis: ``TP_SMOKE`` where it has
    attention, ``TP_SMOKE_SSM`` where it has Mamba2 layers,
    ``TP_SMOKE_MOE`` where it has experts."""
    over = {}
    if cfg.n_heads:
        over.update(TP_SMOKE)
    if cfg.family in ("ssm", "hybrid"):
        over.update(TP_SMOKE_SSM)
    if cfg.family == "moe":
        over.update(TP_SMOKE_MOE)
    return dataclasses.replace(cfg, **over)


def hsdp_mesh(world: int, multi_pod: bool = False, device_type: str | None = None,
              model: int = 1):
    """The launcher's ``(pods, world // (pods * model), model)`` mesh over
    ("pod", "data", "model"), ``pods`` 2 under ``multi_pod``."""
    pods = 2 if multi_pod else 1
    if model < 1 or world % (pods * model):
        raise ValueError(f"{pods} pod(s) x a model axis of {model} do not divide a world of "
                         f"{world} ranks")
    return make_mesh((pods, world // (pods * model), model), MESH_AXES, device_type)


def _dp_mesh(mesh):
    return mesh[tuple(n for n in ("pod", "data") if n in mesh.mesh_dim_names)]


def fsdp_shard_dim(name: str, shape, data: int) -> int:
    """The dim FSDP2 shards parameter ``name`` of (this rank's) ``shape`` on
    over ``data`` ranks: 0 where ``data`` divides dim 0 or dim 0 is at
    least ``data`` (another dim costs FSDP2 a copy of the parameter around
    each gather and reduce-scatter); else JAX's ``fsdp`` dim
    (:func:`~repro_torch.parallel.specs.logical_axes_for`) where ``data``
    divides it, as a rank's stack of fewer experts than data ranks; else 0,
    padded (JAX replicates such a parameter)."""
    if not shape or shape[0] % data == 0 or shape[0] >= data:
        return 0
    axes = logical_axes_for(name, len(shape))
    d = axes.index("fsdp") if "fsdp" in axes else 0
    return d if shape[d] % data == 0 else 0


def shard_model(model: lm.LM, mesh, seq_shard: bool = False) -> lm.LM:
    """Tensor parallelism over the mesh's ``model`` dim where it is above 1
    (:func:`repro_torch.parallel.tensor.tensor_parallel`, this rank's
    coordinate; ``seq_shard``: with sequence parallelism, JAX's
    ``SP_RULES``, which the launcher itself does not bind), then HSDP: FSDP2 ``fully_shard`` of
    every layer (and encoder layer), then of the model, over the mesh's
    ("pod", "data") dims, each parameter on the dim :func:`fsdp_shard_dim`
    gives its local shape (a rank's stack of one expert over 16 data ranks:
    its ``d_model`` dim, as JAX shards it, where dim 0 would pad 16-fold),
    and ``model.loss``, ``model.prefill`` and
    ``model.decode_step`` registered as forwards of the root (and an
    encoder-decoder's ``cross_kv`` of each decoder layer), so that the
    trainer's loss and serving run inside FSDP2's hooks.  The hybrid's
    shared block runs several times a step and stays in the root's group
    (gathered for the whole step).

    The JAX package's two FSDP wire formats: ``param_gather_dtype=
    "bfloat16"`` gives each layer's group, and the shared block a group of
    its own (gathered once a step: ``models.lm._shared_block``), FSDP2's
    mixed-precision policy (bf16 gathers, fp32 reduce-scatters; the root
    keeps the embeddings, head, final norm and frontend in fp32, as JAX's
    ``gather_view`` does); ``packed_wire`` on the fake-quant backend holds
    every pinned linear's weight out of FSDP2's groups, sharded on its wire
    dim, and gathers it as packed codes at each call
    (:mod:`repro_torch.parallel.fsdp_wire`; a weight that cannot move as
    codes raises ``ValueError``)."""
    from torch.distributed.fsdp import (
        MixedPrecisionPolicy, fully_shard, register_fsdp_forward_method)
    from torch.distributed.tensor import Shard

    cfg = model.cfg
    if cfg.param_gather_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"param_gather_dtype {cfg.param_gather_dtype!r}: float32 or bfloat16")
    sizes = axis_sizes(mesh)
    m = sizes.get("model", 1)
    pinned, _, errors = wire_plan(cfg, {k: tuple(p.shape) for k, p in model.named_parameters()},
                                  sizes.get("data", 1))
    if errors:
        raise ValueError("; ".join(errors))
    if m > 1:
        group = mesh.get_group("model")
        tensor_parallel(model, TensorParallel(mesh.get_local_rank("model"), m, group),
                        seq_shard=seq_shard)
    dp = _dp_mesh(mesh)
    ignored = pin_weights(model, dp, pinned) or None
    names = {id(p): k for k, p in model.named_parameters()}
    data = sizes.get("data", 1)

    def placement(p):
        return Shard(fsdp_shard_dim(names[id(p)], tuple(p.shape), data))

    kw = dict(mesh=dp, ignored_params=ignored, shard_placement_fn=placement)
    if cfg.param_gather_dtype == "bfloat16":
        kw["mp_policy"] = MixedPrecisionPolicy(param_dtype=torch.bfloat16,
                                               reduce_dtype=torch.float32,
                                               cast_forward_inputs=False)
        if model.shared_attn is not None:
            fully_shard(model.shared_attn, reshard_after_forward=False, **kw)
    for layer in [*model.layers, *(model.enc_layers or ())]:
        fully_shard(layer, **kw)
    fully_shard(model, mesh=dp, ignored_params=ignored, shard_placement_fn=placement)
    for name in ("loss", "prefill", "decode_step"):
        register_fsdp_forward_method(model, name)
    if model.cfg.family == "encdec":
        for layer in model.layers:
            register_fsdp_forward_method(layer, "cross_kv")
    return model


def local_batch(batch: dict, mesh) -> dict:
    """This rank's slice of the global ``batch``: part ``pod * data_size +
    data`` of ``pod x data`` along the first axis."""
    sizes = axis_sizes(mesh)
    names = mesh.mesh_dim_names
    coord = dict(zip(names, mesh.get_coordinate()))
    dp = sizes.get("pod", 1) * sizes.get("data", 1)
    i = coord.get("pod", 0) * sizes.get("data", 1) + coord.get("data", 0)
    if any(v.shape[0] % dp for v in batch.values()):
        raise ValueError(f"the batch {[tuple(v.shape) for v in batch.values()]} does not "
                         f"split over {dp} data-parallel ranks")
    return {k: v.chunk(dp, dim=0)[i] for k, v in batch.items()}


def _init_world(device: torch.device) -> tuple[int, int, torch.device]:
    """``torchrun``'s process group: (rank, world, this rank's device)."""
    import torch.distributed as dist

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return dist.get_rank(), dist.get_world_size(), device


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--multi-pod", action="store_true",
                    help="under torchrun: two pods, parameters replicated across them")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="under torchrun: the mesh's model axis (tensor parallelism of "
                         "every family)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    mesh, rank = None, 0
    if int(os.environ.get("WORLD_SIZE", "0")):
        rank, world, device = _init_world(device)
        mesh = hsdp_mesh(world, args.multi_pod, device.type, args.model_axis)
    elif args.multi_pod or args.model_axis != 1:
        raise ValueError("--multi-pod and --model-axis train across ranks: run them under "
                         "torchrun")
    shape = SHAPES[args.shape]
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        if args.model_axis > 1:
            cfg = tp_smoke(cfg)
        batch_size, seq = args.batch or 8, args.seq or 64
    else:
        cfg = shape_model_config(get_config(args.arch), shape)
        batch_size, seq = args.batch or shape.global_batch, args.seq or shape.seq_len
    # the cell as run: with --batch/--seq the JAX launcher sizes the
    # accumulation by the shape's own batch, which need not divide the batch
    run_shape = dataclasses.replace(shape, global_batch=batch_size, seq_len=seq)
    mb = 0 if args.smoke else choose_microbatch(
        cfg, run_shape, mesh if mesh is not None else MeshShape(MESH_AXES, (1, 1, 1)))
    run = RunConfig(model=cfg, shape=run_shape, microbatch=mb)
    train_step, opt_init = make_train_step(run)

    model = lm.init_lm(cfg, seed=run.seed, device=device)
    if mesh is not None:
        shard_model(model, mesh)
    opt = opt_init(model)
    data = make_lm_iterator(batch=batch_size, seq=seq, vocab=cfg.vocab, device=device)
    ckpt_dir = args.ckpt_dir
    if ckpt_dir and mesh is not None:
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        params = local_params(model)
        st = mgr.restore({"params": params, "opt": opt, "data": data.state_dict()})
        with torch.no_grad():
            for k, v in st["params"].items():
                params[k].copy_(v)
        opt, start = st["opt"], mgr.latest_step()
        data.load_state_dict(st["data"])
        if rank == 0:
            print(f"resumed from step {start}")

    mon = StragglerMonitor()
    losses = []
    for i in range(start, args.steps):
        batch = next(data)
        if mesh is not None:
            batch = local_batch(batch, mesh)
        mon.start()
        model, opt, metrics = train_step(model, opt, batch)
        loss = metrics["loss"]
        if mesh is not None:  # the global batch's loss: the mean of the ranks'
            import torch.distributed as dist

            loss = loss.clone()
            dist.all_reduce(loss)
            loss = loss / dist.get_world_size()
        loss = float(loss)  # waits for the step
        dt = mon.stop()
        losses.append(loss)
        if rank == 0 and ((i + 1) % 10 == 0 or i == start):
            print(f"step {i + 1}: loss={loss:.4f} gnorm={float(metrics['grad_norm']):.2f} "
                  f"{dt:.2f}s")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": local_params(model), "opt": opt,
                             "data": data.state_dict()}, blocking=False)
    if mgr:
        mgr.wait()
    report = mon.report()
    if rank == 0:
        print("straggler report:", report)
    return {"start": start, "losses": losses, "straggler": report, "microbatch": mb,
            "world": 1 if mesh is None else math.prod(axis_sizes(mesh).values()),
            "model": model, "opt": opt}


if __name__ == "__main__":
    main()
