"""Worlds of gloo processes on the CPU for the port's distributed tests
(``tests/test_torch_parallel.py``, ``test_torch_compress.py``,
``test_torch_launch.py``).  Imports no JAX: each worker runs the port alone
and saves what it computed for the test process to check.

:func:`run_world` spawns ``world`` ranks of ``fn(rank, world, port, *args)``
on one torch thread each and returns every rank's saved result.
"""
from __future__ import annotations

import dataclasses
import os
import socket
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _main(rank: int, world: int, port: int, out: str, fn, args) -> None:
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_RANK=str(rank))
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        torch.save(fn(rank, world, *args), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def run_world(fn, world: int, *args) -> list:
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank")
        mp.spawn(_main, args=(world, _free_port(), out, fn, args), nprocs=world, join=True)
        return [torch.load(f"{out}.{r}", weights_only=False) for r in range(world)]


# ---------------------------------------------------------------------------
# the compressed ring
# ---------------------------------------------------------------------------
def ring_inputs(rank: int, numel: int, seed: int):
    """Rank ``rank``'s gradient (a ragged 1-D numel) and rounding bytes."""
    g = torch.Generator().manual_seed(seed * 1000 + rank)
    grad = torch.randn(numel, generator=g) * (1e-3 * (rank + 1))
    rows = -(-numel // 128)
    r_u8 = torch.randint(0, 256, (rows, 128), generator=g, dtype=torch.uint8)
    return grad, r_u8


def ring_worker(rank: int, world: int, numel: int, seed: int):
    from repro_torch.parallel import compress

    grad, r_u8 = ring_inputs(rank, numel, seed)
    compress.reset_wire_counts()
    out = compress.crosspod_allreduce_mean(grad, None, r_u8=r_u8)
    return {"out": out, "wire": dict(compress.WIRE)}


# ---------------------------------------------------------------------------
# sharding on a ("pod", "data") mesh
# ---------------------------------------------------------------------------
def placements_worker(rank: int, world: int):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.parallel import (
        DEFAULT_RULES, SP_RULES, PartitionSpec, axis_rules, placements, shard, wire_pin)
    from repro_torch.parallel.specs import spec_for

    mesh = make_mesh((2, world // 2), ("pod", "data"), "cpu")
    res = {"coord": mesh.get_coordinate()}
    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    dx = distribute_tensor(x, mesh, (Replicate(), Replicate()))
    with axis_rules(DEFAULT_RULES, mesh):
        b = shard(dx, "batch", None)
        res["batch"] = (b.placements, b.to_local().clone())
        res["plain_is_identity"] = shard(x, "batch", None) is x
        w = distribute_tensor(x, mesh, (Replicate(), Replicate()))
        pinned = wire_pin(shard(w, "fsdp", None), 0)
        res["wire_pin"] = (pinned.placements, torch.equal(pinned.full_tensor(), x))
        res["wire_pin_plain"] = wire_pin(x, 0) is x
    with axis_rules(SP_RULES, mesh):
        s = wire_pin(distribute_tensor(x, mesh, (Replicate(), Shard(1))), 0)
        res["wire_pin_sp"] = s.placements
    res["no_rules"] = shard(dx, "batch", None) is dx
    res["param"] = placements(spec_for("layers.0.attn.wo.w", (64, 32), mesh, DEFAULT_RULES), mesh)
    res["batch_spec"] = placements(PartitionSpec(("pod", "data"), None), mesh)
    return res


# ---------------------------------------------------------------------------
# the launcher's HSDP step
# ---------------------------------------------------------------------------
HSDP_BATCH, HSDP_SEQ = 8, 16


def hsdp_worker(rank: int, world: int, cases):
    """:func:`hsdp_case` of each ``(arch, quant, remat)`` case, by case."""
    return {case: hsdp_case(world, *case) for case in cases}


def hsdp_case(world: int, arch: str, quant: bool, remat: str):
    """Gradients of one loss on this rank's slice (full tensors); with the
    smoke config as shipped (``quant``), also two steps of the launcher
    (``train.main`` under the world, ``--multi-pod``) and the parameters
    after them, local shards and full tensors."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import make_lm_iterator
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = dataclasses.replace(get_smoke_config(arch), quant=quant, remat=remat)
    mesh = train.hsdp_mesh(world, multi_pod=True, device_type="cpu")
    model = train.shard_model(lm.init_lm(cfg, seed=0, device="cpu"), mesh)
    batch = next(make_lm_iterator(batch=HSDP_BATCH, seq=HSDP_SEQ, vocab=cfg.vocab,
                                  device="cpu"))
    loss, _ = model.loss(train.local_batch(batch, mesh), 7)
    loss.backward()
    res = {"coord": tuple(mesh.get_coordinate()), "loss": loss.detach(),
           "grads": {k: p.grad.full_tensor() for k, p in model.named_parameters()},
           "placements": {k: p.placements for k, p in model.named_parameters()}}
    if cfg == get_smoke_config(arch):
        out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                          "--multi-pod", "--batch", str(HSDP_BATCH), "--seq", str(HSDP_SEQ)])
        res["losses"], res["world"] = out["losses"], out["world"]
        res["local"] = {k: p.to_local().clone() for k, p in out["model"].named_parameters()}
        res["params"] = {k: p.full_tensor() for k, p in out["model"].named_parameters()}
    return res
