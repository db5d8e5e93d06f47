"""Worlds of gloo processes on the CPU for the port's distributed tests
(``tests/test_torch_parallel.py``, ``test_torch_compress.py``,
``test_torch_launch.py``).  Imports no JAX: each worker runs the port alone
and saves what it computed for the test process to check.

:func:`run_world` spawns ``world`` ranks of ``fn(rank, world, port, *args)``
on one torch thread each and returns every rank's saved result;
:func:`start_world` and :func:`finish_world` do the same in two steps, so
that worlds can run side by side.
"""
from __future__ import annotations

import collections
import contextlib
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
    return finish_world(start_world(fn, world, *args))


def start_world(fn, world: int, *args):
    """Spawn the world's ranks and return at once; :func:`finish_world`
    waits for them."""
    tmp = tempfile.TemporaryDirectory()
    out = os.path.join(tmp.name, "rank")
    ctx = mp.start_processes(_main, args=(world, _free_port(), out, fn, args), nprocs=world,
                             join=False, start_method="spawn")
    return ctx, tmp, out, world


def finish_world(started) -> list:
    """Every rank's saved result of a world :func:`start_world` spawned."""
    ctx, tmp, out, world = started
    with tmp:
        while not ctx.join():
            pass
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


# ---------------------------------------------------------------------------
# tensor parallelism over the model axis
# ---------------------------------------------------------------------------
TP_BATCH, TP_SEQ, TP_KEY = 8, 16, 7
TP_BACKENDS = ("off", "fake_quant", "pallas")
# (linear, kind, d_in, d_out) of the narrowed smoke config
TP_LINEARS = (("mlp.w_up", "column", 64, 640), ("mlp.w_down", "row", 640, 64),
              ("attn.wq", "column", 64, 512), ("attn.wo", "row", 512, 64))


def tp_config(backend: str, **over):
    """chatglm3-6b's smoke config widened as the launcher widens it under a
    model axis (``TP_SMOKE``: 128-wide heads, 2 kv heads, d_ff of 5
    groups), fp32, quantization off or on ``backend``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import TP_SMOKE

    cfg = dataclasses.replace(get_smoke_config("chatglm3-6b"), **TP_SMOKE, **over)
    if backend == "off":
        return dataclasses.replace(cfg, quant=False)
    return dataclasses.replace(cfg, quant_backend=backend)


TP_SRC = 12  # the encoder-decoder's source frames


def tp_batches(cfg, batch: int = TP_BATCH):
    """The test stream of global batches; the encoder-decoder's carry
    ``src_emb`` (TP_SRC frames)."""
    from repro_torch.data import make_lm_iterator

    extras = ((("src_emb", (batch, TP_SRC, cfg.frontend_dim)),) if cfg.family == "encdec"
              else ())
    return make_lm_iterator(batch=batch, seq=TP_SEQ, vocab=cfg.vocab, extras=extras,
                            device="cpu")


def tp_batch(cfg, batch: int = TP_BATCH):
    return next(tp_batches(cfg, batch))


def _tp_linear_case(cfg, name: str, kind: str, d_in: int, d_out: int, layout, tp):
    """One linear, unsharded and this rank's tensor-parallel part, on the
    same seeded inputs: (ref y, dx, dw) and (y, dx, dw, bounds)."""
    ref, (yt, dxt, dwt, pieces) = _linear_case(cfg, layout[f"layers.0.{name}.w"], kind, d_in,
                                               d_out, tp, len(name) * 100 + d_out)
    (a, b), = pieces
    return ref, (yt, dxt, dwt, (a, b))


def _linear_case(cfg, sp, kind: str, d_in: int, d_out: int, tp, seed: int):
    """A linear of weight split ``sp``, unsharded and this rank's
    tensor-parallel part, on the same seeded inputs: (ref y, dx, dw) and
    (y, dx, dw, the rank's pieces)."""
    import numpy as np

    from repro_torch.models import nn as L
    from repro_torch.parallel.tensor import Split, TPLinear, copy_to_tp

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((2, TP_SEQ, d_in)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((2, TP_SEQ, d_out)) * 1e-3).astype(np.float32))
    qcfg = cfg.qcfg()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = L.linear(xr, wr, None, qcfg, TP_KEY)
    y.backward(g)
    lin = TPLinear.of(kind, sp, tp)
    last = Split(-1, sp.pieces)  # the same pieces of an activation's last dim
    if kind == "column":
        xt, wt = x.clone().requires_grad_(), sp.take(w, tp.rank).clone().requires_grad_()
        yt = lin(L.linear, copy_to_tp(xt, tp), wt, None, qcfg, TP_KEY, None)
        yt.backward(last.take(g, tp.rank))
    else:
        xt = last.take(x, tp.rank).clone().requires_grad_()
        wt = sp.take(w, tp.rank).clone().requires_grad_()
        yt = lin(L.linear, xt, wt, None, qcfg, TP_KEY, None)
        yt.backward(g)
    return ((y.detach(), xr.grad, wr.grad), (yt.detach(), xt.grad, wt.grad, sp.pieces[tp.rank]))


def _tp_quantizers(tp):
    """Sharded operands quantized as slices (K1's split path with the
    group, the fake-quant quantize_operand with a shard) and the unsharded
    operands quantized whole, on this rank's slices."""
    import numpy as np

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT, GroupSpec, QuantConfig
    from repro_torch.core.lowbit import Sharded, quantize_operand
    from repro_torch.kernels import mls_quantize, quantize_ref

    rng = np.random.default_rng(5)
    out = {}
    for dim, shape in ((1, (32, 640)), (0, (640, 256))):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        x[rng.integers(shape[0]), rng.integers(shape[1])] = 9.0  # one rank's max
        r = torch.from_numpy(rng.integers(0, 256, shape).astype(np.uint8))
        full = shape[dim]
        a, b = (0, 384) if tp.rank == 0 else (384, full)
        take = (slice(None), slice(a, b)) if dim == 1 else (slice(a, b), slice(None))
        got = mls_quantize(x[take].contiguous(), FMT_IMAGENET, 128, GS_FMT_DEFAULT,
                           r[take].contiguous(), "nc", group=tp.group)
        want = quantize_ref(x, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc")
        qcfg = QuantConfig(fmt=FMT_IMAGENET, backend="fake_quant", k_block=128)
        spec = GroupSpec((1, 128)) if dim == 1 else GroupSpec((128, 1))
        gen_shard = Sharded(dim, ((a, b),), full, tp.group)
        fq = quantize_operand(x[take], qcfg, spec, TP_KEY, 1, shard=gen_shard)
        fq_want = quantize_operand(x, qcfg, spec, TP_KEY, 1)
        out[dim] = dict(take=(a, b), got=got, want=want, fq=fq, fq_want=fq_want)
    return out


def _tp_step(cfg, state, tp, key, fed: bool = False, seq_shard: bool = False, batch=None):
    """This rank's tensor-parallel loss and gradients of ``state`` (an
    unsharded state dict) and the unsharded model's, on one batch; the
    launches recorded in the tensor-parallel step, by kernel.  ``fed``:
    each linear of the tensor-parallel step is fed the unsharded step's
    input and output gradient (this rank's part), so that every quantizer
    sees the unsharded operand's values (:func:`_linear_feed`).
    ``seq_shard``: with sequence parallelism, the partial gradients summed
    over the group as the trainer sums them (and ``seq_split``, which
    sequences the loss split).  ``batch``: default ``tp_batch(cfg, 2)``."""
    from repro_torch.kernels import launch
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel
    from repro_torch.train.trainer import sum_partial_grads

    batch = tp_batch(cfg, 2) if batch is None else batch
    full = lm.LM(cfg)
    full.load_state_dict(state)
    records = _linear_feed(full) if fed else None
    loss0, _ = full.loss(batch, key)
    loss0.backward()
    model = lm.LM(cfg)
    model.load_state_dict(state)
    tensor_parallel(model, tp, seq_shard=seq_shard)
    if fed:
        _linear_feed(model, records)
    before = collections.Counter(launch.RECORDED)
    loss1, _ = model.loss(batch, key)
    loss1.backward()
    recs = collections.Counter()
    for (kernel, *_), n in (collections.Counter(launch.RECORDED) - before).items():
        recs[kernel] += n
    grads = {k: p.grad for k, p in model.named_parameters()}
    if seq_shard:
        grads = sum_partial_grads(model, {k: g.clone() for k, g in grads.items()})
    return dict(loss=loss1.detach(), ref_loss=loss0.detach(), layout=model.tp_layout,
                grads=grads, ref_grads={k: p.grad for k, p in full.named_parameters()},
                launches=dict(recs), seq_split=dict(model.seq_split))


class _Feed(torch.autograd.Function):
    """``value`` in place of ``x``; the gradient passed to ``x``."""

    @staticmethod
    def forward(ctx, x, value):
        return value.clone()

    @staticmethod
    def backward(ctx, g):
        return g, None


def _linear_feed(model, records: dict | None = None) -> dict:
    """Hooks on every linear of the layers, the encoder's layers and the
    shared block, and on every MoE layer: with no ``records``, record each
    call's input and output gradient by (name, call); with them (an
    unsharded model's), feed each call of this tensor-parallel model the
    recorded input and output gradient, its rank's part (column-parallel:
    the output's pieces; row-parallel: the input's; an MoE's are whole;
    under sequence parallelism, a call given ``seq`` the tokens of it that
    its input and output hold).  Returns the records."""
    from repro_torch.parallel.tensor import Split

    out = {} if records is None else records
    calls: collections.Counter = collections.Counter()
    for name, mod in model.named_modules():
        if (not name.startswith(("layers.", "enc_layers.", "shared_attn."))
                or type(mod).__name__ not in ("Linear", "MoE")):
            continue

        linear = type(mod).__name__ == "Linear"

        def pre(m, args, kwargs, name=name, linear=linear):
            key = (name, calls[name])
            calls[name] += 1
            if records is None:
                out[key] = {"x": args[0].detach()}
                m._feed_key = key
                return None
            x = records[key]["x"]
            seq = kwargs.get("seq")
            m._feed_seq = seq
            if linear and m.tp is not None and m.tp.kind == "row":
                x = Split(x.ndim - 1, (m.tp.pieces,)).take(x, 0)
            elif seq is not None:  # a whole linear or an MoE on the rank's tokens
                x = seq.take(x)
            m._feed_key = key
            return (_Feed.apply(args[0], x),) + tuple(args[1:]), kwargs

        def post(m, args, kwargs, y, name=name, linear=linear):
            rec = out[m._feed_key]
            y = y if linear else y[0]  # an MoE returns (y, aux)
            if not y.requires_grad:  # serving: no gradient to record or feed
                return None
            if records is None:
                y.register_hook(lambda g: rec.__setitem__("g", g.detach()))
                return None
            g = rec["g"]
            if linear and m.tp is not None and m.tp.kind == "column":
                g = Split(g.ndim - 1, (m.tp.pieces,)).take(g, 0)
            elif m._feed_seq is not None:  # an output on the rank's tokens
                g = m._feed_seq.take(g)
            y.register_hook(lambda _: g)
            return None

        mod.register_forward_pre_hook(pre, with_kwargs=True)
        mod.register_forward_hook(post, with_kwargs=True)
    return out


def _state(cfg, seed: int = 0):
    from repro_torch.models import lm

    return lm.init_lm(cfg, seed=seed, device="cpu").state_dict()


def tp2_worker(rank: int, world: int, jax_state):
    """World 2, model 2: the linears and quantizers of each backend, the
    step of each backend against the unsharded port, the unquantized step
    on the JAX package's parameters (``jax_state``), and two microbatch-2
    steps of the launcher's train step on the global batch."""
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.data import make_lm_iterator
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import TensorParallel, tensor_parallel, tp_layout
    from repro_torch.train import make_train_step

    tp = TensorParallel.of()
    res = {"linears": {}, "steps": {}}
    for backend in TP_BACKENDS:
        cfg = tp_config(backend)
        layout = tp_layout(cfg, {k: tuple(t.shape) for k, t in _state(cfg).items()}, 2)
        for name, kind, d_in, d_out in TP_LINEARS:
            res["linears"][(backend, name)] = _tp_linear_case(cfg, name, kind, d_in, d_out,
                                                              layout, tp)
        res["steps"][backend] = _tp_step(cfg, _state(cfg), tp, TP_KEY, fed=backend != "off")
    res["quantizers"] = _tp_quantizers(tp)
    res["jax"] = _tp_step(tp_config("off"), jax_state, tp, None)
    cfg = tp_config("fake_quant")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TP_BATCH, seq_len=TP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=2))
    model = tensor_parallel(lm.init_lm(cfg, seed=0, device="cpu"), tp)
    opt = init(model)
    data = make_lm_iterator(batch=TP_BATCH, seq=TP_SEQ, vocab=cfg.vocab, device="cpu")
    losses, gnorms = [], []
    for _ in range(2):
        model, opt, m = step(model, opt, next(data))
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
    res["microbatch"] = dict(losses=losses, gnorms=gnorms,
                             params={k: p.detach().clone() for k, p in model.named_parameters()})
    return res


def tp4_worker(rank: int, world: int):
    """World 4: two launcher steps at data 2 x model 2 (``--model-axis 2``,
    HSDP over the data axis) and, at model 4 (the kv heads replicated), the
    step of each backend against the unsharded port."""
    from repro_torch.launch import train
    from repro_torch.parallel.tensor import TensorParallel

    out = train.main(["--arch", "chatglm3-6b", "--smoke", "--device", "cpu", "--steps", "2",
                      "--model-axis", "2", "--batch", str(TP_BATCH), "--seq", str(TP_SEQ)])
    model = out["model"]
    mesh_coord = (rank // 2, rank % 2)  # (data, model) of the (1, 2, 2) mesh
    res = {"coord": mesh_coord, "losses": out["losses"], "world": out["world"],
           "params": {k: p.full_tensor() for k, p in model.named_parameters()},
           "steps": {}}
    tp = TensorParallel.of()
    for backend in TP_BACKENDS:
        cfg = tp_config(backend)
        res["steps"][backend] = _tp_step(cfg, _state(cfg), tp, TP_KEY, fed=backend != "off")
    return res


# ---------------------------------------------------------------------------
# tensor parallelism of the ssm and hybrid families
# ---------------------------------------------------------------------------
SSM_ARCHS = ("mamba2-370m", "zamba2-7b")


def smoke_tp_config(arch: str, backend: str, **over):
    """``arch``'s smoke config widened as the launcher widens it under a
    model axis (``launch.train.tp_smoke``: attention as ``TP_SMOKE``; a
    Mamba2 layer's d_model 256, 16 heads of 32 in a din of 4 scaling
    groups; an MoE's moe_d_ff 640), fp32, quantization off or on
    ``backend``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import tp_smoke

    cfg = dataclasses.replace(tp_smoke(get_smoke_config(arch)), **over)
    if backend == "off":
        return dataclasses.replace(cfg, quant=False)
    return dataclasses.replace(cfg, quant_backend=backend)


def _microbatch_steps(cfg, tp, steps: int = 2) -> dict:
    """``steps`` microbatch-2 steps of the launcher's train step on the
    global batches, this rank's model tensor-parallel over the whole
    world: the losses and the parameters after them."""
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel
    from repro_torch.train import make_train_step

    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TP_BATCH, seq_len=TP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=2))
    model = tensor_parallel(lm.init_lm(cfg, seed=0, device="cpu"), tp)
    opt = init(model)
    data = tp_batches(cfg)
    losses = []
    for _ in range(steps):
        model, opt, m = step(model, opt, next(data))
        losses.append(m["loss"].item())
    return dict(losses=losses, params={k: p.detach().clone() for k, p in model.named_parameters()})


def _ssm_linears(cfg, tp):
    """in_proj (column-parallel, several pieces; the tail on rank 0) and
    out_proj (row-parallel) of ``cfg``'s layer 0, by name."""
    from repro_torch.parallel.tensor import tp_layout

    shapes = {k: tuple(t.shape) for k, t in _state(cfg).items()}
    layout = tp_layout(cfg, shapes, tp.size)
    out = {}
    for name, kind in (("in_proj", "column"), ("out_proj", "row")):
        sp = layout[f"layers.0.{name}.w"]
        d_in, d_out = shapes[f"layers.0.{name}.w"]
        out[name] = _linear_case(cfg, sp, kind, d_in, d_out, tp, 31 + d_out)
    return out


def _ssm_quantizers(tp, cfg):
    """The in_proj's sharded operands of several pieces quantized as slices
    of the unsharded ones: its error (rows, N) along N with the ragged
    ``dt`` group on rank 0 through qd_gemm's K1 path (padded to k_block, the
    unsharded operand's bytes), its w^T (N, K) along the rows, and both on
    the fake-quant quantizer (the error's one group a row, ragged N, shared
    over the ranks)."""
    import numpy as np

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT, GroupSpec, QuantConfig
    from repro_torch.core.lowbit import Sharded, quantize_operand
    from repro_torch.kernels import quantize_ref, rounding_bytes
    from repro_torch.kernels.lowbit_conv import _quantize
    from repro_torch.parallel.tensor import tp_layout

    sp = tp_layout(cfg, {k: tuple(t.shape) for k, t in _state(cfg).items()},
                   tp.size)["layers.0.in_proj.w"]
    pieces, n = sp.pieces[tp.rank], sp.full
    rng = np.random.default_rng(9)
    out = {"pieces": pieces, "full": n}
    fq = QuantConfig(fmt=FMT_IMAGENET, backend="fake_quant", k_block=128)
    for dim, shape in ((1, (32, n)), (0, (n, 256))):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        x[rng.integers(shape[0]), rng.integers(shape[1])] = 9.0  # one rank's max
        shard = Sharded(dim, pieces, n, tp.group)
        local = shard.take(x, sum(b - a for a, b in pieces))
        pad = (-n) % 128 if dim == 1 else (-shape[1]) % 128
        lpad = (-local.shape[1]) % 128
        gen = torch.Generator().manual_seed(3)
        got = _quantize(torch.nn.functional.pad(local, (0, lpad)).contiguous(), local.shape[1],
                        shard, gen, FMT_IMAGENET, 128, GS_FMT_DEFAULT, "nc")
        xp = torch.nn.functional.pad(x, (0, pad)).contiguous()
        r = rounding_bytes(xp.shape, torch.Generator().manual_seed(3), xp.device)
        want = quantize_ref(xp, FMT_IMAGENET, 128, GS_FMT_DEFAULT, r, "nc")
        spec = GroupSpec((1, 128)) if dim == 1 else GroupSpec((128, 1))
        fq_got = quantize_operand(local, fq, spec, TP_KEY, 2, shard=shard)
        fq_want = quantize_operand(x, fq, spec, TP_KEY, 2)
        out[dim] = dict(got=got, want=want, fq=fq_got, fq_want=fq_want)
    return out


def ssm_tp2_worker(rank: int, world: int, jax_states):
    """World 2, model 2, for each ssm/hybrid arch: the in_proj and out_proj
    of each backend, the in_proj's quantizers, the step of each backend
    against the unsharded port (quantized: fed its operands), the
    unquantized step on the JAX package's parameters (``jax_states``, by
    arch), and two microbatch-2 steps of the launcher's train step on the
    global batch."""
    from repro_torch.parallel.tensor import TensorParallel

    tp = TensorParallel.of()
    res = {"linears": {}, "steps": {}, "jax": {}, "microbatch": {}}
    for arch in SSM_ARCHS:
        for backend in TP_BACKENDS:
            for name, case in _ssm_linears(smoke_tp_config(arch, backend), tp).items():
                res["linears"][(arch, backend, name)] = case
            cfg = smoke_tp_config(arch, backend)
            res["steps"][(arch, backend)] = _tp_step(cfg, _state(cfg), tp, TP_KEY,
                                                     fed=backend != "off")
        res["jax"][arch] = _tp_step(smoke_tp_config(arch, "off"), jax_states[arch], tp, None)
        res["microbatch"][arch] = _microbatch_steps(smoke_tp_config(arch, "fake_quant"), tp)
    res["quantizers"] = _ssm_quantizers(tp, smoke_tp_config("zamba2-7b", "pallas"))
    return res


def ssm_tp4_worker(rank: int, world: int):
    """World 4: two launcher steps of each ssm/hybrid arch at data 2 x model 2
    (``--model-axis 2``, HSDP over the data axis) and mamba2's step of each
    backend at model 4 against the unsharded port (quantized: fed its
    operands)."""
    from repro_torch.launch import train
    from repro_torch.parallel.tensor import TensorParallel

    res = {"coord": (rank // 2, rank % 2), "launcher": {}, "steps": {}}
    for arch in SSM_ARCHS:
        out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                          "--model-axis", "2", "--batch", str(TP_BATCH), "--seq", str(TP_SEQ)])
        res["launcher"][arch] = dict(
            losses=out["losses"], world=out["world"],
            params={k: p.full_tensor() for k, p in out["model"].named_parameters()})
    tp = TensorParallel.of()
    for backend in TP_BACKENDS:
        cfg = smoke_tp_config("mamba2-370m", backend)
        res["steps"][backend] = _tp_step(cfg, _state(cfg), tp, TP_KEY, fed=backend != "off")
    return res


# ---------------------------------------------------------------------------
# tensor parallelism of the moe and encdec families
# ---------------------------------------------------------------------------
MOE_ARCHS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e")
ENCDEC_ARCH = "seamless-m4t-medium"


def _moe_layer_case(cfg, tp) -> list[dict]:
    """Layer 0's MoE, unsharded and this rank's tensor-parallel part, on the
    same seeded input and output gradient (the aux loss's gradient 1): by
    run, its output, aux loss, input gradient and parameter gradients, the
    gathered expert outputs ``ye``, the stack's own outputs (this rank's
    experts), the buffer's gradient and the rank's experts."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel

    state = _state(cfg)
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.standard_normal((2, TP_SEQ, cfg.d_model)).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((2, TP_SEQ, cfg.d_model)) * 1e-2).astype(np.float32))
    out = []
    for sharded in (False, True):
        model = lm.LM(cfg)
        model.load_state_dict(state)
        if sharded:
            tensor_parallel(model, tp)
        moe, rec = model.layers[0].moe, {}
        experts, stack = moe._experts, moe._stack

        def spy_experts(xe, qcfg, key, experts=experts, rec=rec):
            xe.register_hook(lambda grad: rec.__setitem__("xe_grad", grad))
            ye = experts(xe, qcfg, key)
            rec["ye"] = ye.detach()
            return ye

        def spy_stack(xe, qcfg, key, span, stack=stack, rec=rec):
            y = stack(xe, qcfg, key, span)
            rec["local"] = y.detach()
            return y

        moe._experts, moe._stack = spy_experts, spy_stack
        xr = x.clone().requires_grad_()
        y, aux = moe(xr, cfg.qcfg(), TP_KEY)
        (torch.sum(y * g) + aux).backward()
        rec.update(y=y.detach(), aux=aux.detach(), dx=xr.grad, experts=moe.experts,
                   grads={k: p.grad for k, p in moe.named_parameters()})
        out.append(rec)
    return out


def moe_tp2_worker(rank: int, world: int, jax_states):
    """World 2, model 2, for each moe arch: layer 0's MoE of each backend
    (:func:`_moe_layer_case`), the step of each backend against the
    unsharded port (quantized: fed its operands, each MoE layer's input and
    output gradient too), the unquantized step on the JAX package's
    parameters (``jax_states``, by arch), and two microbatch-2 steps of the
    launcher's train step on the global batch."""
    from repro_torch.parallel.tensor import TensorParallel

    tp = TensorParallel.of()
    res = {"layers": {}, "steps": {}, "jax": {}, "microbatch": {}}
    for arch in MOE_ARCHS:
        for backend in TP_BACKENDS:
            cfg = smoke_tp_config(arch, backend)
            res["layers"][(arch, backend)] = _moe_layer_case(cfg, tp)
            res["steps"][(arch, backend)] = _tp_step(cfg, _state(cfg), tp, TP_KEY,
                                                     fed=backend != "off")
        res["jax"][arch] = _tp_step(smoke_tp_config(arch, "off"), jax_states[arch], tp, None)
        res["microbatch"][arch] = _microbatch_steps(smoke_tp_config(arch, "fake_quant"), tp)
    return res


def moe_tp4_worker(rank: int, world: int):
    """World 4: two launcher steps of each moe arch at data 2 x model 2
    (``--model-axis 2``, HSDP over the data axis) and moonshot's step of
    each backend at model 4 (one of its 4 experts a rank) against the
    unsharded port (quantized: fed)."""
    from repro_torch.launch import train
    from repro_torch.parallel.tensor import TensorParallel

    res = {"coord": (rank // 2, rank % 2), "launcher": {}, "steps": {}}
    for arch in MOE_ARCHS:
        out = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
                          "--model-axis", "2", "--batch", str(TP_BATCH), "--seq", str(TP_SEQ)])
        res["launcher"][arch] = dict(
            losses=out["losses"], world=out["world"],
            params={k: p.full_tensor() for k, p in out["model"].named_parameters()})
    tp = TensorParallel.of()
    for backend in TP_BACKENDS:
        cfg = smoke_tp_config(MOE_ARCHS[0], backend)
        res["steps"][backend] = _tp_step(cfg, _state(cfg), tp, TP_KEY, fed=backend != "off")
    return res


def _xattn_linear_cases(cfg, tp) -> dict:
    """Layer 0's cross-attention ``wk`` and ``wv`` on a source of TP_SRC
    frames, unsharded and this rank's column-parallel part over
    ``copy_to_tp`` of the source (:func:`_linear_case`), by name."""
    import numpy as np

    from repro_torch.models import nn as L
    from repro_torch.parallel.tensor import Split, TPLinear, copy_to_tp, tp_layout

    shapes = {k: tuple(t.shape) for k, t in _state(cfg).items()}
    layout = tp_layout(cfg, shapes, tp.size)
    out = {}
    for name in ("wk", "wv"):
        sp = layout[f"layers.0.xattn.{name}.w"]
        d_in, d_out = shapes[f"layers.0.xattn.{name}.w"]
        rng = np.random.default_rng(len(name) + d_out)
        mem = torch.from_numpy(rng.standard_normal((2, TP_SRC, d_in)).astype(np.float32))
        w = torch.from_numpy((rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32))
        g = torch.from_numpy((rng.standard_normal((2, TP_SRC, d_out)) * 1e-3).astype(np.float32))
        qcfg = cfg.qcfg()
        mr, wr = mem.clone().requires_grad_(), w.clone().requires_grad_()
        y = L.linear(mr, wr, None, qcfg, TP_KEY)
        y.backward(g)
        mt, wt = mem.clone().requires_grad_(), sp.take(w, tp.rank).clone().requires_grad_()
        yt = TPLinear.of("column", sp, tp)(L.linear, copy_to_tp(mt, tp), wt, None, qcfg,
                                          TP_KEY, None)
        yt.backward(Split(-1, sp.pieces).take(g, tp.rank))
        out[name] = ((y.detach(), mr.grad, wr.grad),
                     (yt.detach(), mt.grad, wt.grad, sp.pieces[tp.rank]))
    return out


def _hsdp_steps(cfg, mesh, steps: int = 2) -> dict:
    """``steps`` steps of the launcher's train step (no accumulation) on
    this rank's slice of the global batches, the model sharded by
    ``launch.train.shard_model`` over ``mesh``: the global losses (the mean
    over the world) and the full parameters after them."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.train import make_train_step

    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TP_BATCH, seq_len=TP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=0))
    model = train.shard_model(lm.init_lm(cfg, seed=0, device="cpu"), mesh)
    opt = init(model)
    data = tp_batches(cfg)
    losses = []
    for _ in range(steps):
        model, opt, m = step(model, opt, train.local_batch(next(data), mesh))
        loss = m["loss"].detach().clone()
        dist.all_reduce(loss)
        losses.append(loss.item() / dist.get_world_size())
    return dict(losses=losses, world=dist.get_world_size(),
                params={k: p.full_tensor() for k, p in model.named_parameters()})


def encdec_tp2_worker(rank: int, world: int, jax_state):
    """World 2, model 2: the cross-attention's wk and wv of each backend,
    the step of each backend against the unsharded port (quantized: fed its
    operands), the unquantized step on the JAX package's parameters
    (``jax_state``), and two microbatch-2 steps of the launcher's train
    step on the global batch."""
    from repro_torch.parallel.tensor import TensorParallel

    tp = TensorParallel.of()
    res = {"xattn": {}, "steps": {}}
    for backend in TP_BACKENDS:
        cfg = smoke_tp_config(ENCDEC_ARCH, backend)
        res["xattn"][backend] = _xattn_linear_cases(cfg, tp)
        res["steps"][backend] = _tp_step(cfg, _state(cfg), tp, TP_KEY, fed=backend != "off")
    res["jax"] = _tp_step(smoke_tp_config(ENCDEC_ARCH, "off"), jax_state, tp, None)
    res["microbatch"] = _microbatch_steps(smoke_tp_config(ENCDEC_ARCH, "fake_quant"), tp)
    return res


def encdec_tp4_worker(rank: int, world: int):
    """World 4: two steps at data 2 x model 2 through ``shard_model`` and
    the train step (the launcher's stream carries no ``src_emb``), and the
    step of each backend at model 4 (the kv heads replicated) against the
    unsharded port (quantized: fed)."""
    from repro_torch.launch import train
    from repro_torch.parallel.tensor import TensorParallel

    mesh = train.hsdp_mesh(world, device_type="cpu", model=2)
    res = {"coord": (rank // 2, rank % 2), "steps": {},
           "hsdp": _hsdp_steps(smoke_tp_config(ENCDEC_ARCH, "fake_quant"), mesh)}
    tp = TensorParallel.of()
    for backend in TP_BACKENDS:
        cfg = smoke_tp_config(ENCDEC_ARCH, backend)
        res["steps"][backend] = _tp_step(cfg, _state(cfg), tp, TP_KEY, fed=backend != "off")
    return res


# ---------------------------------------------------------------------------
# serving a tensor-parallel model
# ---------------------------------------------------------------------------
SERVE_ARCHS = ("chatglm3-6b", "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "mamba2-370m",
               "zamba2-7b", "seamless-m4t-medium")
SERVE_BATCH, SERVE_PROMPT, SERVE_STEPS, SERVE_MAX = 2, 8, 4, 16


def serve_config(arch: str, backend: str):
    """The arch's smoke config widened for a model axis: chatglm3-6b's as
    :func:`tp_config` widens it, the others' as :func:`smoke_tp_config`."""
    return tp_config(backend) if arch == "chatglm3-6b" else smoke_tp_config(arch, backend)


def serve_inputs(cfg):
    """The prompts (SERVE_BATCH x SERVE_PROMPT tokens; the encoder-decoder's
    with TP_SRC source frames) and the SERVE_STEPS teacher-forced decode
    tokens, from numpy's seeded generator."""
    import numpy as np

    rng = np.random.default_rng(11)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT)))}
    if cfg.family == "encdec":
        batch["src_emb"] = torch.from_numpy(
            rng.standard_normal((SERVE_BATCH, TP_SRC, cfg.frontend_dim)).astype(np.float32))
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (SERVE_BATCH, SERVE_STEPS)))
    return batch, steps


def _serve_run(model, cfg) -> dict:
    """A prefill of :func:`serve_inputs`' prompts and SERVE_STEPS decode
    steps teacher-forced on its tokens: every step's logits, layer 0's
    cache tensors after the prefill, and the launches of the last decode
    step by kernel."""
    from repro_torch.kernels import launch
    from repro_torch.models import lm

    batch, steps = serve_inputs(cfg)
    logits, cache = lm.prefill(model, batch, SERVE_MAX)
    out = {"logits": [logits], "cache0": {k: v[0].clone() for k, v in cache.items() if k != "pos"}}
    for i in range(SERVE_STEPS):
        before = collections.Counter(launch.RECORDED)
        logits, cache = lm.decode_step(model, cache, steps[:, i:i + 1])
        out["logits"].append(logits)
    recs = collections.Counter()
    for (kernel, *_), n in (collections.Counter(launch.RECORDED) - before).items():
        recs[kernel] += n
    out["logits"], out["decode_launches"] = torch.stack(out["logits"]), dict(recs)
    return out


def _rank_cache_slices(model, cache0: dict, rank: int) -> dict:
    """This rank's slice of an unsharded model's layer-0 cache tensors:
    the kv heads its attention reads (K/V, the hybrid's ring buffer, the
    cross K/V), its Mamba2 heads' conv channels and SSM states."""
    out = {}
    attn = None
    if model.cfg.family == "hybrid":
        attn = model.shared_attn.attn
    elif model.cfg.n_heads and model.cfg.family != "ssm":
        attn = model.layers[0].attn
    for name, t in cache0.items():
        if name in ("k", "v", "ak", "av", "xk", "xv") and attn.tp is None:
            out[name] = t  # a replicated attention caches every kv head
        elif name in ("k", "v", "ak", "av", "xk", "xv"):
            hkv = attn.heads[1]
            kv0, kv1 = attn.kv_take or (rank * hkv, (rank + 1) * hkv)
            out[name] = t[:, :, kv0:kv1]
        elif name == "conv":
            pieces = model.tp_layout["layers.0.conv_w"].pieces[rank]
            out[name] = torch.cat([t[..., a:b] for a, b in pieces], dim=-1)
        else:  # ssm
            h0, h1 = model.layers[0].heads
            out[name] = t[:, h0:h1]
    return out


def serve_case(arch: str, backend: str, tp, state=None, cfg=None) -> dict:
    """``arch`` served unsharded and as this rank's tensor-parallel part, on
    the same weights (``state``, else seed 0's) and inputs; quantized, each
    linear (and MoE layer) of the tensor-parallel run fed the unsharded
    run's input (:func:`_linear_feed`).  Returns both runs' logits, whether
    layer 0's cache after the prefill is the rank's slice of the unsharded
    one bit for bit (by tensor) and its relative L2 distance from it, the
    rank's cache shapes against
    ``cache_spec(..., tp=...)``, the tensor-parallel run's launches of a
    decode step, and, unquantized, both engines' greedy tokens.  ``cfg``:
    another config than :func:`serve_config`'s."""
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel
    from repro_torch.serve import ServeEngine

    cfg = cfg or serve_config(arch, backend)
    state = _state(cfg) if state is None else state
    fed = backend != "off"
    full = lm.LM(cfg)
    full.load_state_dict(state)
    records = _linear_feed(full) if fed else None
    ref = _serve_run(full, cfg)
    model = lm.LM(cfg)
    model.load_state_dict(state)
    tensor_parallel(model, tp)
    if fed:
        _linear_feed(model, records)
    got = _serve_run(model, cfg)
    want = _rank_cache_slices(model, ref["cache0"], tp.rank)
    spec = lm.cache_spec(cfg, SERVE_BATCH, SERVE_MAX, TP_SRC, tp)
    res = dict(logits=got["logits"], ref_logits=ref["logits"],
               cache_exact={k: torch.equal(got["cache0"][k], want[k]) for k in want},
               cache_rel={k: float((got["cache0"][k].double() - want[k].double()).norm()
                                   / max(float(want[k].double().norm()), 1e-30)) for k in want},
               cache_shapes={k: (tuple(v.shape), tuple(spec[k][0][1:]))
                             for k, v in got["cache0"].items()},
               decode_launches=got["decode_launches"], ref_launches=ref["decode_launches"])
    if not fed:
        batch, _ = serve_inputs(cfg)
        res["tokens"] = ServeEngine(cfg, model, max_len=SERVE_MAX).generate(batch, 6)
        res["ref_tokens"] = ServeEngine(cfg, full, max_len=SERVE_MAX, device="cpu").generate(
            batch, 6)
    return res


def serve_tp2_worker(rank: int, world: int, jax_states):
    """World 2, model 2: :func:`serve_case` of every SERVE_ARCHS arch on
    each backend, the teacher-forced logits of the unquantized
    tensor-parallel run on the JAX package's parameters (``jax_states``,
    by arch), and the forward's whole logits against the unsharded
    forward's."""
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import TensorParallel, tensor_parallel

    tp = TensorParallel.of()
    res = {"cases": {}, "jax": {}, "forward": {}}
    for arch in SERVE_ARCHS:
        for backend in TP_BACKENDS:
            res["cases"][(arch, backend)] = serve_case(arch, backend, tp)
        if arch in jax_states:
            cfg = serve_config(arch, "off")
            model = lm.LM(cfg)
            model.load_state_dict(jax_states[arch])
            tensor_parallel(model, tp)
            res["jax"][arch] = _serve_run(model, cfg)["logits"]
        cfg = serve_config(arch, "off")
        batch, _ = serve_inputs(cfg)
        full = lm.LM(cfg)
        full.load_state_dict(_state(cfg))
        model = lm.LM(cfg)
        model.load_state_dict(_state(cfg))
        tensor_parallel(model, tp)
        with torch.no_grad():
            res["forward"][arch] = (model(batch), full(batch))
    return res


def serve_tp4_worker(rank: int, world: int):
    """World 4: chatglm3-6b at model 4 (its 2 kv heads replicated, a rank's
    cache the one its query heads read), :func:`serve_case` on each
    backend; then the dense model served through ``launch.train.
    shard_model`` at data 2 x model 2 (FSDP2 over the data axis, the
    prefill and decode run as registered forwards), each data rank on its
    half of the prompts: its greedy tokens and logits."""
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import TensorParallel
    from repro_torch.serve import ServeEngine

    tp = TensorParallel.of()
    res = {"cases": {b: serve_case("chatglm3-6b", b, tp) for b in TP_BACKENDS}}
    cfg = serve_config("chatglm3-6b", "off")
    mesh = train.hsdp_mesh(world, device_type="cpu", model=2)
    model = train.shard_model(lm.init_lm(cfg, seed=0, device="cpu"), mesh)
    batch = train.local_batch(serve_inputs(cfg)[0], mesh)
    res["hsdp"] = dict(coord=(rank // 2, rank % 2), logits=lm.prefill(model, batch, SERVE_MAX)[0],
                       tokens=ServeEngine(cfg, model, max_len=SERVE_MAX).generate(batch, 6))
    return res


# ---------------------------------------------------------------------------
# what the model axis does not divide: uneven heads, replicated attention
# and vocabulary
# ---------------------------------------------------------------------------
# case: (arch, overrides of its widened smoke config); every case at model 4
UNEVEN_CASES = {
    # 10 query heads of 128 over 2 kv heads (5 a kv head): 3 / 3 / 2 / 2,
    # rank 1's heads 3, 4, 5 reading kv heads 0, 0, 1
    "uneven": ("chatglm3-6b", dict(n_heads=10, n_kv_heads=2)),
    # 2 heads of 32, one scaling group of 128 between them: fewer units than
    # ranks, the attention whole on every rank (unquantized too: 2 < 4)
    "attn_dense": ("chatglm3-6b", dict(n_heads=2, n_kv_heads=1, head_dim=32)),
    "attn_encdec": ("seamless-m4t-medium", dict(n_heads=2, n_kv_heads=2, head_dim=32)),
    "attn_hybrid": ("zamba2-7b", dict(n_heads=2, n_kv_heads=2, head_dim=32)),
    # a vocabulary of 101 over 4 ranks: emb and lm_head whole on every rank
    "vocab_untied": ("chatglm3-6b", dict(vocab=101)),
    "vocab_tied": ("mamba2-370m", dict(vocab=101)),
}
UNEVEN_AXIS = 4


def uneven_config(case: str, backend: str):
    """The case's widened smoke config (:func:`serve_config`) with its
    overrides, quantization off or on ``backend``."""
    arch, over = UNEVEN_CASES[case]
    return dataclasses.replace(serve_config(arch, backend), **over)


def _attention_cases(cfg, tp) -> dict:
    """Each attention of layer 0 (and the encoder's, and the hybrid's
    shared block's), unsharded and as this rank runs it, on one seeded
    input, cross-attention source and output gradient: by name, each run's
    output, input and source gradients and weight gradients, and whether
    the rank's attention stayed replicated (no group)."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel

    state = _state(cfg)
    runs = []
    for sharded in (False, True):
        model = lm.LM(cfg)
        model.load_state_dict(state)
        if sharded:
            tensor_parallel(model, tp)
        out = {}
        for name, attn in model.named_modules():
            if (type(attn).__name__ != "Attention"
                    or not name.startswith(("layers.0.", "enc_layers.0.", "shared_attn."))):
                continue
            rng = np.random.default_rng(len(name))
            x = torch.from_numpy(rng.standard_normal((2, TP_SEQ, cfg.d_model)).astype(np.float32))
            mem = torch.from_numpy(rng.standard_normal((2, TP_SRC, cfg.d_model)).astype(np.float32))
            g = torch.from_numpy((rng.standard_normal((2, TP_SEQ, cfg.d_model)) * 1e-2)
                                 .astype(np.float32))
            xr, mr = x.clone().requires_grad_(), mem.clone().requires_grad_()
            cross = name.endswith("xattn")
            y = attn(xr, cfg.qcfg(), TP_KEY, kv=mr if cross else None,
                     causal=not name.startswith("enc_layers."))
            y.backward(g)
            out[name] = dict(y=y.detach(), dx=xr.grad, dmem=mr.grad if cross else None,
                             grads={k: p.grad for k, p in attn.named_parameters()},
                             replicated=attn.tp is None)
        runs.append(out)
    return dict(ref=runs[0], got=runs[1])


def uneven_tp4_worker(rank: int, world: int, jax_states):
    """World 4, model 4, each UNEVEN_CASES case: the step of each backend
    against the unsharded port (quantized: fed its operands), the
    unquantized step on the JAX package's parameters (``jax_states``, by
    case), each attention of the replicated-attention cases against the
    unsharded one (:func:`_attention_cases`), and :func:`serve_case` of
    each backend; also each rank's heads and kv map of the uneven case."""
    from repro_torch.parallel.tensor import TensorParallel, kv_map, rank_heads

    tp = TensorParallel.of()
    res = {"steps": {}, "jax": {}, "attention": {}, "serve": {}}
    for case, (arch, _) in UNEVEN_CASES.items():
        for backend in TP_BACKENDS:
            cfg = uneven_config(case, backend)
            res["steps"][(case, backend)] = _tp_step(cfg, _state(cfg), tp, TP_KEY,
                                                     fed=backend != "off")
            if case.startswith("attn_"):
                res["attention"][(case, backend)] = _attention_cases(cfg, tp)
            res["serve"][(case, backend)] = serve_case(arch, backend, tp, cfg=cfg)
        res["jax"][case] = _tp_step(uneven_config(case, "off"), jax_states[case], tp, None)
    cfg = uneven_config("uneven", "pallas")
    res["heads"] = (rank_heads(cfg, tp.size, tp.rank), kv_map(cfg, tp.size, tp.rank))
    return res


# ---------------------------------------------------------------------------
# sequence parallelism (tensor_parallel(..., seq_shard=True))
# ---------------------------------------------------------------------------
SP_ARCHS = ("chatglm3-6b", "moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "mamba2-370m",
            "zamba2-7b", "seamless-m4t-medium")
# the uneven cases' sequence on the quantized backend: 128 tokens a rank at
# model 4, whole scaling groups for the token-sliced operands' weight
# gradient (one row of them)
SP_SEQ_QUANTIZED = 512
SP_LINEAR = (2, 256, 256, 320)  # the token-split linear's batch, tokens, d_in, d_out


def sp_jax_config():
    """The JAX package's SP semantics test's config
    (``tests/test_dryrun_smoke.py``): glm4-9b's smoke config unquantized,
    4 query and 4 kv heads."""
    from repro_torch.configs import get_smoke_config

    return dataclasses.replace(get_smoke_config("glm4-9b"), quant=False, n_heads=4,
                               n_kv_heads=4)


def sp_batch(cfg, seq: int = TP_SEQ, src: int = TP_SRC, batch: int = 2):
    """``batch`` rows of ``seq`` tokens (the encoder-decoder's over ``src``
    frames) from numpy's seeded generator."""
    import numpy as np

    rng = np.random.default_rng(seq + src)
    out = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (batch, seq)))}
    if cfg.family == "encdec":
        out["src_emb"] = torch.from_numpy(
            rng.standard_normal((batch, src, cfg.frontend_dim)).astype(np.float32))
    return out


def _sp_raw_step(cfg, state, tp, seq_shard: bool, batch) -> dict:
    """This rank's loss and gradients (the partial ones summed over the
    group) of a tensor-parallel model of ``state``, unfed, and the
    launches by kernel."""
    from repro_torch.kernels import launch
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel
    from repro_torch.train.trainer import sum_partial_grads

    model = lm.LM(cfg)
    model.load_state_dict(state)
    tensor_parallel(model, tp, seq_shard=seq_shard)
    before = collections.Counter(launch.RECORDED)
    loss, _ = model.loss(batch, TP_KEY)
    loss.backward()
    recs = collections.Counter()
    for (kernel, *_), n in (collections.Counter(launch.RECORDED) - before).items():
        recs[kernel] += n
    grads = sum_partial_grads(model, {k: p.grad.clone() for k, p in model.named_parameters()})
    return dict(loss=loss.detach(), grads=grads, layout=model.tp_layout, launches=dict(recs),
                seq_split=dict(model.seq_split))


def _sp_prefill(cfg, state, tp, seq_shard: bool) -> dict:
    """A prefill of :func:`serve_inputs`' prompts on this rank's model:
    the last position's logits and the rank's cache (every layer)."""
    from repro_torch.models import lm
    from repro_torch.parallel.tensor import tensor_parallel

    model = lm.LM(cfg)
    model.load_state_dict(state)
    tensor_parallel(model, tp, seq_shard=seq_shard)
    logits, cache = lm.prefill(model, serve_inputs(cfg)[0], SERVE_MAX)
    return dict(logits=logits, cache={k: v for k, v in cache.items() if k != "pos"})


def _sp_collectives(tp) -> dict:
    """gather_seq and scatter_seq of seeded rank tensors, forward and
    backward, with the inputs the test rebuilds their closed forms from."""
    from repro_torch.parallel.tensor import SeqShard, gather_seq, scatter_seq

    sp = SeqShard(tp, 4 * tp.size)
    g = torch.Generator().manual_seed(100 + tp.rank)
    x = torch.randn(2, sp.n, 3, generator=g).requires_grad_()
    gy = torch.randn(2, sp.full, 3, generator=g)
    y = gather_seq(x, sp)
    y.backward(gy)
    p = torch.randn(2, sp.full, 3, generator=g).requires_grad_()
    gz = torch.randn(2, sp.n, 3, generator=g)
    z = scatter_seq(p, sp)
    z.backward(gz)
    return dict(x=x.detach(), gy=gy, y=y.detach(), dx=x.grad, p=p.detach(), gz=gz,
                z=z.detach(), dp=p.grad)


def _token_linear(cfg, tp) -> dict:
    """A linear whose weight stays whole run unsharded and on this rank's
    tokens (``LinearSplit.tokens``, ``SP_LINEAR``'s shapes), on the same
    seeded inputs; and its operands quantized as token slices (K1's split
    entries, the fake-quant quantizer) beside the unsharded ones."""
    import numpy as np

    from repro_torch.core.lowbit import LinearSplit, quantize_operand
    from repro_torch.kernels import mls_quantize, quantize_ref
    from repro_torch.models import nn as L
    from repro_torch.parallel.tensor import SeqShard

    b, s, d_in, d_out = SP_LINEAR
    sp = SeqShard(tp, s)
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((b, s, d_in)).astype(np.float32))
    x[1, rng.integers(s), rng.integers(d_in)] = 9.0  # one rank's max
    w = torch.from_numpy((rng.standard_normal((d_in, d_out)) * 0.05).astype(np.float32))
    g = torch.from_numpy((rng.standard_normal((b, s, d_out)) * 1e-3).astype(np.float32))
    qcfg = cfg.qcfg()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = L.linear(xr, wr, None, qcfg, TP_KEY)
    y.backward(g)
    xt, wt = sp.take(x).clone().requires_grad_(), w.clone().requires_grad_()
    yt = L.linear(xt, wt, None, qcfg, TP_KEY, split=sp.split())
    yt.backward(sp.take(g))
    out = dict(start=sp.start, n=sp.n, ref=(y.detach(), xr.grad, wr.grad),
               got=(yt.detach(), xt.grad, wt.grad))
    # the operands alone: rows of a flattened (b s, d) operand, one piece a row
    x2 = x.reshape(b * s, d_in)
    rows = torch.cat([x2[i * s + sp.start:i * s + sp.start + sp.n] for i in range(b)])
    r = torch.from_numpy(rng.integers(0, 256, x2.shape).astype(np.uint8))
    r_rows = torch.cat([r[i * s + sp.start:i * s + sp.start + sp.n] for i in range(b)])
    out["k1"] = (mls_quantize(rows.contiguous(), qcfg.fmt, 128, qcfg.gs_fmt, r_rows.contiguous(),
                              "nc", group=tp.group),
                 quantize_ref(x2, qcfg.fmt, 128, qcfg.gs_fmt, r, "nc"))
    fq = dataclasses.replace(qcfg, backend="fake_quant")
    spec = fq.matmul_specs(x.shape, w.shape)[0]
    out["fake_quant"] = (quantize_operand(sp.take(x), fq, spec, TP_KEY, 0,
                                          shard=LinearSplit.tokens(
                                              ((sp.start, sp.start + sp.n),), s, tp.group).x),
                         quantize_operand(x, fq, spec, TP_KEY, 0))
    return out


def sp2_worker(rank: int, world: int):
    """World 2, model 2: the collectives; for each SP_ARCHS arch and
    backend the SP step against the DEFAULT step (unfed, both) and against
    the unsharded port (quantized: fed; unquantized, the unfed SP step
    itself), the prefill under SP and DEFAULT; and the token-split linear
    on both quantized backends."""
    from repro_torch.parallel.tensor import TensorParallel

    tp = TensorParallel.of()
    res = {"collectives": _sp_collectives(tp), "steps": {}, "prefill": {}, "linear": {}}
    for arch in SP_ARCHS:
        for backend in TP_BACKENDS:
            cfg = serve_config(arch, backend)
            state, batch = _state(cfg), sp_batch(cfg)
            fed = _tp_step(cfg, state, tp, TP_KEY, fed=backend != "off", seq_shard=True,
                           batch=batch)
            res["steps"][(arch, backend)] = dict(
                default=_sp_raw_step(cfg, state, tp, False, batch),
                sp=fed if backend == "off" else _sp_raw_step(cfg, state, tp, True, batch),
                fed=fed)
            if backend != "fake_quant":
                res["prefill"][(arch, backend)] = dict(
                    default=_sp_prefill(cfg, state, tp, False),
                    sp=_sp_prefill(cfg, state, tp, True))
    for backend in TP_BACKENDS[1:]:
        res["linear"][backend] = _token_linear(tp_config(backend), tp)
    return res


def _sp_attention_cases(cfg, tp, seq: int) -> dict:
    """Each attention of layer 0 (and the encoder's, and the hybrid's shared
    block's) unsharded and as this rank runs it under sequence parallelism
    (its tokens of ``seq``, the cross-attention's source split too), on one
    seeded input, source and output gradient, rounding to nearest (a
    stochastic code can move with the order of K/V's gradient sum, which
    the steps' fed runs cover): by name, the output, input and source
    gradients (the rank's tokens) and the weight gradients (the rank's part
    of their sum over the tokens)."""
    import numpy as np

    from repro_torch.models import lm
    from repro_torch.parallel.tensor import SeqShard, tensor_parallel

    state = _state(cfg)
    sp, msp = SeqShard(tp, seq), SeqShard(tp, seq)
    rows = 1 if seq == SP_SEQ_QUANTIZED else 2
    runs = []
    for sharded in (False, True):
        model = lm.LM(cfg)
        model.load_state_dict(state)
        if sharded:
            tensor_parallel(model, tp, seq_shard=True)
        out = {}
        for name, attn in model.named_modules():
            if (type(attn).__name__ != "Attention"
                    or not name.startswith(("layers.0.", "enc_layers.0.", "shared_attn."))):
                continue
            rng = np.random.default_rng(len(name))
            x = torch.from_numpy(rng.standard_normal((rows, seq, cfg.d_model))
                                 .astype(np.float32))
            mem = torch.from_numpy(rng.standard_normal((rows, seq, cfg.d_model))
                                   .astype(np.float32))
            g = torch.from_numpy((rng.standard_normal((rows, seq, cfg.d_model)) * 1e-2)
                                 .astype(np.float32))
            cross = name.endswith("xattn")
            kw = dict(kv=mem if cross else None, causal=not name.startswith("enc_layers."))
            if sharded:
                x, mem, g = sp.take(x), msp.take(mem), sp.take(g)
                kw.update(kv=mem if cross else None, seq=sp, mem_seq=msp if cross else None)
            xr, mr = x.clone().requires_grad_(), mem.clone().requires_grad_()
            if cross:
                kw["kv"] = mr
            y = attn(xr, cfg.qcfg(), None, **kw)  # nearest rounding: see the test
            y.backward(g)
            out[name] = dict(y=y.detach(), dx=xr.grad, dmem=mr.grad if cross else None,
                             grads={k: p.grad for k, p in attn.named_parameters()},
                             whole=attn.tp is None)
        runs.append(out)
    return dict(ref=runs[0], got=runs[1], start=sp.start, n=sp.n, rows=rows)


def sp_uneven_seq(backend: str) -> int:
    """The uneven cases' training sequence under sequence parallelism: on
    the quantized backend, whose token slices (an attention kept whole,
    replicated kv linears: every case but the tied vocabulary's) take whole
    scaling groups, SP_SEQ_QUANTIZED; else TP_SEQ."""
    return SP_SEQ_QUANTIZED if backend == "pallas" else TP_SEQ


def sp4_worker(rank: int, world: int, jax_state):
    """World 4, model 4: the unquantized SP step of :func:`sp_jax_config`
    on the JAX package's parameters (``jax_state``); each UNEVEN_CASES case
    and backend: the SP step against the unsharded port (quantized: fed)
    and, of the replicated-attention cases, each attention of layer 0 under
    sequence parallelism against the unsharded one
    (:func:`_sp_attention_cases`)."""
    from repro_torch.parallel.tensor import TensorParallel

    tp = TensorParallel.of()
    cfg = sp_jax_config()
    res = {"steps": {}, "attention": {},
           "jax": _tp_step(cfg, jax_state, tp, None, seq_shard=True, batch=sp_batch(cfg))}
    for case in UNEVEN_CASES:
        for backend in TP_BACKENDS:
            cfg = uneven_config(case, backend)
            seq = sp_uneven_seq(backend)
            rows = 1 if seq == SP_SEQ_QUANTIZED else 2
            res["steps"][(case, backend)] = _tp_step(
                cfg, _state(cfg), tp, TP_KEY, fed=backend != "off", seq_shard=True,
                batch=sp_batch(cfg, seq, seq, rows))
            if case.startswith("attn_"):
                res["attention"][(case, backend)] = _sp_attention_cases(cfg, tp, seq)
    return res


# ---------------------------------------------------------------------------
# the FSDP wire formats: the 2-byte and the 1-byte weight gather
# ---------------------------------------------------------------------------
WIRE_KEY = 7
# (arch, backend, levers): the 2-byte gather against one process
WIRE_BF16_CASES = tuple((arch, backend, "bf16") for arch in ("chatglm3-6b", "zamba2-7b",
                                                            "seamless-m4t-medium")
                        for backend in ("fake_quant", "pallas"))
# the 1-byte gather: packed against unpacked, each without and with bf16;
# mamba2-370m widened (d_model 256) so that its in_proj's data slice holds
# whole scaling groups (16-wide, 16 of them), the smoke configs' 64-wide
# in-projections one group spanning the split
WIRE_PACKED_CASES = (("chatglm3-6b", "fake_quant", "packed"), ("chatglm3-6b", "fake_quant", ""),
                     ("mamba2-370m", "fake_quant", "packed"), ("mamba2-370m", "fake_quant", ""),
                     ("zamba2-7b", "fake_quant", "packed"), ("zamba2-7b", "fake_quant", ""),
                     ("chatglm3-6b", "fake_quant", "packed+bf16"))
WIRE_LEVERS = {"": {}, "bf16": {"param_gather_dtype": "bfloat16"},
               "packed": {"packed_wire": True},
               "packed+bf16": {"packed_wire": True, "param_gather_dtype": "bfloat16"}}


def wire_config(arch: str, backend: str, levers: str):
    """The smoke config of ``arch`` on ``backend`` with ``levers`` on
    (:data:`WIRE_LEVERS`); mamba2-370m widened to ``TP_SMOKE_SSM``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import TP_SMOKE_SSM

    cfg = get_smoke_config(arch)
    if arch == "mamba2-370m":
        cfg = dataclasses.replace(cfg, **TP_SMOKE_SSM)
    return dataclasses.replace(cfg, quant_backend=backend, **WIRE_LEVERS[levers])


def _wire_case(cfg, mesh, counted: bool) -> dict:
    """One loss's gradients (full tensors) on this rank's slice of the first
    global batch, then two steps of the launcher's train step (no
    accumulation) from the same start: the global losses, the parameters
    after them (full and this rank's shards); ``counted``: the loss and its
    backward under ``trace_counts.StepCounter`` (wire bytes by op and
    payload dtype)."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.launch import train
    from repro_torch.launch.trace_counts import StepCounter, mesh_dims
    from repro_torch.models import lm
    from repro_torch.train import make_train_step

    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=TP_BATCH, seq_len=TP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=0))
    model = train.shard_model(lm.init_lm(cfg, seed=0, device="cpu"), mesh)
    data = tp_batches(cfg)
    first = next(tp_batches(cfg))
    counter = StepCounter(mesh_dims(mesh))
    with counter if counted else contextlib.nullcontext():
        loss, _ = model.loss(train.local_batch(first, mesh), WIRE_KEY)
        loss.backward()
    res = {"coord": tuple(mesh.get_coordinate()), "loss": loss.detach(),
           "grads": {k: p.grad.full_tensor() for k, p in model.named_parameters()},
           "wire": counter.hlo()["coll_breakdown"] if counted else None,
           "pinned": sorted(k for k, m in model.named_modules()
                            if getattr(m, "wire", None) is not None)}
    opt = init(model)
    losses = []
    for _ in range(2):
        model, opt, m = step(model, opt, train.local_batch(next(data), mesh))
        loss = m["loss"].detach().clone()
        dist.all_reduce(loss)
        losses.append(loss.item() / dist.get_world_size())
    res.update(losses=losses,
               params={k: p.full_tensor() for k, p in model.named_parameters()},
               local={k: p.to_local().clone() for k, p in model.named_parameters()})
    return res


def _wire_gather_case(mesh) -> dict:
    """A weight of chatglm3-6b's smoke config gathered as codes over the data
    group, at nearest rounding: this rank's slice and the gathered unit
    values and tensor scale, beside the slice's bounds."""
    from repro_torch.core.lowbit import QuantConfig, Sharded, quantize_operand

    cfg = QuantConfig(packed_wire=True, shard_ways=16, backend="fake_quant")
    w = torch.randn(256, 96, generator=torch.Generator().manual_seed(5))
    d, r = mesh.size(mesh.mesh_dim_names.index("data")), mesh.get_local_rank("data")
    out = {}
    for dim in (0, 1):
        n = w.shape[dim] // d
        sh = Sharded(dim, ((r * n, (r + 1) * n),), w.shape[dim], mesh.get_group("data"))
        spec = cfg.matmul_specs((1, 256), tuple(w.shape))[1]
        unit, s_t = quantize_operand(w.narrow(dim, r * n, n), cfg, spec, None, 1,
                                     wire_shard=sh)
        out[dim] = (unit, s_t)
    return {"w": w, "gathered": out}


def wire_worker(rank: int, world: int, cases):
    """World 4, 2 pods x 2 data: :func:`_wire_case` of each ``(arch,
    backend, levers)`` case (the packed chatglm3-6b one and its unpacked
    twin counted), and the gather of one weight."""
    from repro_torch.launch import train

    mesh = train.hsdp_mesh(world, multi_pod=True, device_type="cpu")
    out = {case: _wire_case(wire_config(*case), mesh, case[0] == "chatglm3-6b"
                            and case[2] in ("", "packed"))
           for case in cases}
    out["gather"] = _wire_gather_case(mesh)
    return out


# ---------------------------------------------------------------------------
# the FSDP2 placement: a rank's stack of fewer experts than data ranks
# ---------------------------------------------------------------------------
PLACEMENT_ARCH = "llama4-scout-17b-a16e"


def placement_config():
    """llama4-scout's smoke config widened for a model axis of 2
    (``launch.train.tp_smoke``), fp32, with 2 experts: one a rank."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.train import tp_smoke

    return dataclasses.replace(tp_smoke(get_smoke_config(PLACEMENT_ARCH)), n_experts=2,
                               quant=False)


def placement_worker(rank: int, world: int):
    """World 4, data 2 x model 2 (``launch.train.shard_model``): each
    parameter's placements, rank shape and local shard; one loss's
    gradients on this rank's slice of the global batch (this rank's
    tensor-parallel parts, full over data); one launcher step
    (:func:`_hsdp_steps`)."""
    from repro_torch.launch import train
    from repro_torch.models import lm

    cfg = placement_config()
    mesh = train.hsdp_mesh(world, device_type="cpu", model=2)
    model = train.shard_model(lm.init_lm(cfg, seed=0, device="cpu"), mesh)
    loss, _ = model.loss(train.local_batch(tp_batch(cfg), mesh), TP_KEY)
    loss.backward()
    params = dict(model.named_parameters())
    return {"coord": tuple(mesh.get_coordinate()), "loss": loss.detach(),
            "layout": model.tp_layout,
            "placements": {k: p.placements for k, p in params.items()},
            "shapes": {k: tuple(p.shape) for k, p in params.items()},
            "local": {k: tuple(p.to_local().shape) for k, p in params.items()},
            "grads": {k: p.grad.full_tensor() for k, p in params.items()},
            "step": _hsdp_steps(cfg, mesh, steps=1)}
