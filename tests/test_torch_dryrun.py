"""The dry run (``repro_torch.launch.dryrun``): train and serve cells of
the production meshes traced on fake tensors under a fake process group,
with rank 0's memory, dot FLOPs and wire bytes, against the JAX package's
``launch/dryrun.py`` and against closed forms.

- **Against JAX.**  JAX's ``run_cell`` runs in a subprocess (its XLA device
  count is fixed at import), on mamba2-370m, chatglm3-6b and yi-34b at
  train_4k and on chatglm3-6b at prefill_32k and decode_32k, 16x16, two
  layers; mamba2-370m's vocabulary of 50280 stays replicated over the
  model axis of 16 in both.  ``microbatch`` (train), ``n_devices`` and
  ``mesh`` are equal.  The raw ratios are printed.  The port's rank 0
  runs dots and holds tensors a JAX device does not, by design, each
  named with its closed form (:func:`by_design`): the kv heads a model
  axis of 16 does not divide, or that an uneven split of the query heads
  leaves whole, stay whole on every rank (JAX splits their columns); the
  port's split in whole groups and heads gives rank 0 the extra scaling
  groups and heads (yi-34b's 4 query heads of 56 where a JAX device holds
  3.5; and, of a Mamba2 layer, the in_proj's tail); PyTorch's full remat recomputes
  each residual branch's last GEMM, whose output no backward rule reads
  (XLA drops it); serving, a rank's cache holds the kv heads its query
  heads read over the whole sequence, where JAX splits the cache's
  sequence over ``model`` (:func:`cache_by_design`).  Less those,
  ``dot_flops`` is within 5% of JAX's and ``argument_bytes`` within 10%
  (seen: 0.0-1.3% and 0.1-5.5% train, 0.0% and 0.2-1.2% serving).
- **Closed forms.**  ``argument_bytes`` is the sum of rank 0's shards
  (``tp_layout``, then FSDP2's split of ``launch.train.fsdp_shard_dim``'s
  dim, in 512-byte blocks) for the
  parameters and both AdamW moments, plus the batch, exactly; the wire
  bytes of a two-layer toy (FSDP2 over data, a Megatron all-reduce over
  model, a broadcast, a functional all-reduce) are the JAX parse's ring
  formulas (``analysis/hlo_parser.py``) in closed form, each on its mesh dim.
- **Fake against real.**  On smoke configs with fake-quant on the CPU,
  under a fake world of 4 (data 2 x model 2), the fake run's counts and
  tracked peak equal a run of the same step on real CPU tensors, a train
  step, a prefill and a decode step alike.
- **The shape-only branch.**  On fake ``cuda`` operands K1 (one call and
  split entries) and K3 allocate the card branch's outputs (shapes,
  dtypes, device), K3's ordered-split workspace included, and record the
  card's launches; they never reach ``build.library()`` or ``data_ptr()``
  and count no launch (``LAUNCHES`` counts kernels launched).  A real CPU
  tensor still takes the plain version; K2's and K4's wrappers refuse
  fake operands.
- **Cells not run** are recorded: a family the lint does not admit
  ``"refused"`` with its message, at train_4k and at decode_32k; a serve
  cell ``"ran"``, and yi-34b's prefill on both meshes (refused before its
  query heads split unevenly).
- **FSDP wire formats** (``cfg_updates`` of ``param_gather_dtype=
  "bfloat16"``, ``packed_wire``, both): a small cell's all-gather bytes are
  DEFAULT's less the closed-form saving (bf16 halves each layer group's
  two gathers; a pinned weight moves once as 1-byte codes and 4-byte group
  scales instead of twice as fp32), the reduce-scatters unchanged.
- **Sequence parallelism** (``seq_shard=True``, ``SP_RULES``): chatglm3-6b's
  train_4k cell at two layers takes JAX's ``choose_microbatch(...,
  seq_shard=True)``, records ``"rules": "sp"`` and holds fewer activation
  bytes on rank 0; without remat it moves the DEFAULT cell's model-axis
  wire bytes within 1% (an all-reduce is a reduce-scatter and an
  all-gather; seen: 0.013%, the replicated gradients' sum).

``tests/test_torch_dryrun_extension.py`` holds the depth and microbatch
extension equal to whole traces.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import torch.nn as nn  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.core.formats import FMT_IMAGENET, GS_FMT_DEFAULT  # noqa: E402
from repro_torch.kernels import autotune, build, launch, launch_counts  # noqa: E402
from repro_torch.kernels.implicit_conv import implicit_conv_forward  # noqa: E402
from repro_torch.kernels.mls_matmul import matmul_plan, mls_matmul  # noqa: E402
from repro_torch.kernels.mls_quantize import (  # noqa: E402
    mls_quantize, quantize_given_scales, quantize_rows_split)
from repro_torch.kernels.ref import quantize_ref  # noqa: E402
from repro_torch.kernels.lowbit_conv import qd_gemm  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.launch.trace_counts import StepCounter, mesh_dims  # noqa: E402
from repro_torch.launch.train import fsdp_shard_dim, tp_smoke  # noqa: E402
from repro_torch.models.lm import cache_spec as lm_cache_spec  # noqa: E402
from repro_torch.parallel import MeshShape  # noqa: E402
from repro_torch.parallel.specs import param_shardings  # noqa: E402
from repro_torch.parallel.tensor import (  # noqa: E402
    TensorParallel, copy_to_tp, reduce_from_tp, tp_layout)

ROOT = Path(__file__).resolve().parents[1]
FMT = FMT_IMAGENET


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# against the JAX package's dry run
# ---------------------------------------------------------------------------
CROSS = {"mamba2-370m": {"n_layers": 2}, "chatglm3-6b": {"n_layers": 2}, "yi-34b": {"n_layers": 2}}
ROWS, SEQ = 16, 4096  # train_4k's 256 sequences over 16 data ranks
# serve cells against JAX: (arch, shape), and rank 0's tokens a step
SERVE_CROSS = {("chatglm3-6b", "decode_32k"): 128 // 16, ("chatglm3-6b", "prefill_32k"):
               32 // 16 * 32768}
CELLS = [(arch, "train_4k") for arch in CROSS] + list(SERVE_CROSS)
# each residual branch's last GEMM: its output feeds only the residual add
RESIDUAL_LAST = ("attn.wo.w", "mlp.w_down.w", "out_proj.w")

_JAX_SCRIPT = r"""
import json, sys
from repro.launch.dryrun import run_cell
out = {}
for arch, shape, upd in json.loads(sys.argv[1]):
    r = run_cell(arch, shape, False, out_dir=sys.argv[2], verbose=False, cfg_updates=upd)
    rec = {k: r[k] for k in ("microbatch", "n_devices", "mesh") if k in r}
    rec.update(dot_flops=r["hlo"]["dot_flops"],
               argument_bytes=r["memory_analysis"]["argument_bytes"])
    out[arch + "/" + shape] = rec
print("JAX_RECORDS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_records(tmp_path_factory):
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", str(tmp_path_factory.getbasetemp())),
           "JAX_PLATFORMS": "cpu"}
    cells = [(arch, shape, CROSS[arch]) for arch, shape in CELLS]
    r = subprocess.run([sys.executable, "-c", _JAX_SCRIPT, json.dumps(cells),
                        str(tmp_path_factory.mktemp("jax_dryrun"))],
                       capture_output=True, text=True, timeout=900, env=env, cwd=ROOT)
    line = [s for s in r.stdout.splitlines() if s.startswith("JAX_RECORDS")]
    assert line, (r.stdout[-2000:], r.stderr[-4000:])
    return json.loads(line[0][len("JAX_RECORDS"):])


@pytest.fixture(scope="module")
def port_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_dryrun")
    return {f"{arch}/{shape}": dryrun.run_cell(arch, shape, False, out_dir=str(out),
                                               verbose=False, cfg_updates=CROSS[arch])
            for arch, shape in CELLS}, out


def _cfg(arch):
    import dataclasses

    return dataclasses.replace(configs.get_config(arch), **CROSS[arch])


def by_design(cfg, tokens: int, model: int = 16, data: int = 16,
              train: bool = True) -> dict[str, tuple]:
    """``{name: (dot FLOPs, argument bytes, why)}``: what rank 0 of the port
    runs and holds beyond a JAX device, per layer weight.  A linear of
    ``p0`` local weights on rank 0 and ``pe`` on a JAX device runs 4 GEMMs
    of ``2 T p`` FLOPs in the port (forward, remat recompute, data and
    weight gradients) and 4 in JAX, 3 for a residual branch's last linear;
    its weight and both moments are 12 B an element over the data axis.
    Serving (``train`` False) each runs its forward, and holds its weight:
    4 B an element.  A vocabulary the model axis does not divide stays
    whole in both, but GSPMD still splits the LM head's dot over ``model``
    while every port rank runs it whole: ``(m - 1) / m`` of its 3 GEMMs
    (forward, data and weight gradients; serving its forward) more."""
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    layout = tp_layout(cfg, shapes, model)
    jax_specs = param_shardings(abstract_params(cfg), MeshShape(("model",), (model,)))
    out = {}
    head = "emb" if cfg.tie_embeddings else "lm_head"
    if head not in layout:
        n = math.prod(shapes[head])
        out[head] = (2.0 * tokens * (3 if train else 1) * n * (model - 1) / model, 0.0,
                     "the LM head over a vocabulary the model axis does not divide: whole on "
                     "every model rank (GSPMD splits its dot over model)")
    for name, shape in shapes.items():
        if not (name.startswith("layers.") and name.endswith(".w") and len(shape) == 2):
            continue
        n = math.prod(shape)
        split = layout.get(name)
        p0 = n // shape[split.dim] * split.size(0) if split is not None else n
        pe = n // model if any(e is not None for e in jax_specs[name]) else n
        last = train and name.endswith(RESIDUAL_LAST)
        flops = 2.0 * tokens * ((4 if train else 1) * (p0 - pe) + last * pe)
        why = []
        if p0 > pe:
            why.append("whole on every model rank (JAX splits it)" if split is None
                       else f"rank 0 holds {p0} of {n} (JAX {pe}): whole scaling groups "
                            f"and heads")
        if last:
            why.append("its forward recomputed under full remat (XLA drops it)")
        if flops or p0 != pe:
            out[name] = (flops, (12.0 if train else 4.0) * (p0 - pe) / data, "; ".join(why))
    return out


def cache_by_design(cfg, shape, rows: int, model: int = 16, n_dev: int = 256) -> tuple:
    """``(0 FLOPs, argument bytes, why)`` of a decode cell's cache: rank 0
    holds ``rows`` rows of the whole sequence for the kv heads its query
    heads read (``n_kv / m``, or one where the kv heads do not divide),
    bf16 K and V a layer; a JAX device the whole cache over every device
    (``cache_seq`` on ``model``)."""
    kv = cfg.n_kv_heads // model if cfg.n_kv_heads % model == 0 else 1
    per_row = shape.seq_len * cfg.n_layers * 2 * cfg.hd * 2
    port = rows * kv * per_row
    jax_dev = shape.global_batch * cfg.n_kv_heads * per_row / n_dev
    return (0.0, port - jax_dev, f"the cache: rank 0 {port} B ({kv} kv head(s) over the whole "
                                 f"sequence), a JAX device {jax_dev:.0f} B (cache_seq on model)")


@pytest.mark.parametrize("arch,shape", CELLS, ids=lambda v: str(v))
def test_cell_agrees_with_jax_dryrun(arch, shape, jax_records, port_records):
    j, p = jax_records[f"{arch}/{shape}"], port_records[0][f"{arch}/{shape}"]
    for k in ("microbatch", "n_devices", "mesh"):
        assert p.get(k) == j.get(k), (k, p.get(k), j.get(k))
    if shape == "train_4k":
        terms = by_design(_cfg(arch), ROWS * SEQ)
    else:
        terms = by_design(_cfg(arch), SERVE_CROSS[(arch, shape)], train=False)
        if shape.startswith("decode"):  # the cache, an argument (JAX donates it)
            terms["cache"] = cache_by_design(_cfg(arch), configs.SHAPES[shape], p["rows"])
            assert p["cache_bytes"] == terms["cache"][1] + p["cache_bytes_jax_layout"]
    extra_flops = sum(t[0] for t in terms.values())
    extra_bytes = sum(t[1] for t in terms.values())
    flops, args = p["hlo"]["dot_flops"], p["memory_analysis"]["argument_bytes"]
    raw = (flops / j["dot_flops"], args / j["argument_bytes"])
    net = ((flops - extra_flops) / j["dot_flops"], (args - extra_bytes) / j["argument_bytes"])
    named = "\n".join(f"  {k}: +{f:.4g} FLOPs, +{b:.4g} B ({why})"
                      for k, (f, b, why) in terms.items())
    print(f"{arch}: dot_flops port/JAX {raw[0]:.4f} raw, {net[0]:.4f} less the named dots; "
          f"argument_bytes {raw[1]:.4f} raw, {net[1]:.4f} less the named tensors\n{named}")
    assert abs(net[0] - 1) <= 0.05, (arch, raw, net, named)
    assert abs(net[1] - 1) <= 0.10, (arch, raw, net, named)


def test_yi_34b_rank_0_extra_attention_dots_in_closed_form():
    """yi-34b at model 16: rank 0 holds 4 of the 56 query heads of 128 where
    a JAX device holds 3.5, so its wq and wo each run half a head's
    columns more in each of their 4 GEMMs (forward, remat's recompute,
    data and weight gradient; wo also recomputes its 3.5 heads' forward,
    which XLA drops); its 8 kv heads stay whole (JAX: half a head a
    device)."""
    cfg, tokens, d, hd = _cfg("yi-34b"), ROWS * SEQ, 7168, 128
    terms = by_design(cfg, tokens)
    half = 2.0 * tokens * (4 - 3.5) * hd * d  # one GEMM over half a head's columns
    assert terms["layers.0.attn.wq.w"][0] == 4 * half
    assert terms["layers.0.attn.wo.w"][0] == 4 * half + 2.0 * tokens * 3.5 * hd * d
    for kv in ("wk", "wv"):
        assert terms[f"layers.0.attn.{kv}.w"][0] == 4 * 2.0 * tokens * (8 - 0.5) * hd * d
    assert "whole scaling groups and heads" in terms["layers.0.attn.wq.w"][2]


def test_argument_bytes_are_rank_0_shards_in_closed_form(port_records):
    cfg = _cfg("chatglm3-6b")
    rec = port_records[0]["chatglm3-6b/train_4k"]
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    layout = tp_layout(cfg, shapes, 16)

    def blocks(n):
        return -(-n // 512) * 512

    total = 0
    for name, shape in shapes.items():
        shape = list(shape)
        if name in layout:
            shape[layout[name].dim] = layout[name].size(0)  # tensor parallelism: rank 0
        d = fsdp_shard_dim(name, shape, 16)  # FSDP2: rank 0's chunk of the rule's dim
        shape[d] = -(-shape[d] // 16)
        total += 3 * blocks(4 * math.prod(shape))  # fp32 weight, mu, nu
    total += ROWS * SEQ * 8  # int64 tokens
    assert rec["memory_analysis"]["argument_bytes"] == total


def test_records_hold_counts_roofline_and_fit(port_records):
    recs, out = port_records
    for cell, r in recs.items():
        arch, shape = cell.split("/")
        assert r["status"] == "ran" and r["hlo"]["counted_by"] == "fake-tensor trace"
        assert r["hlo"]["dot_flops"] > 0 and r["hlo"]["coll_bytes"] > 0
        assert set(r["hlo"]["coll_by_dim"]) <= {"data", "model"}
        assert r["roofline"]["bottleneck"] in ("compute", "memory", "collective")
        assert r["roofline"]["hlo_flops_per_device"] == r["hlo"]["dot_flops"]
        assert r["peak_bytes"] == (r["memory_analysis"]["argument_bytes"]
                                   + r["memory_analysis"]["temp_bytes"])
        assert r["peak_bytes"] == sum(r["memory_by_kind"].values())
        assert r["fits"] == (r["peak_bytes"] <= r["device_memory_bytes"])
        # the card modelled, not the device that traced: the tile cache's H100
        assert r["modelled_device"] == autotune.modelled_card() == "NVIDIA H100 80GB HBM3"
        assert r["device_memory_bytes"] == roofline.HBM_BYTES
        assert r["compile_s"] is None and r["memory_analysis"]["alias_bytes"] is None
        assert json.loads((out / f"{arch}_{shape}_16x16.json").read_text()) == r
        if shape != "train_4k":  # the roofline's memory term reads the rank's cache
            assert r["roofline"]["hbm_bytes_per_device"] == roofline.hbm_bytes(
                _cfg(arch), configs.SHAPES[shape], MeshShape(("data", "model"), (16, 16)),
                cache_bytes=r["cache_bytes"])
            assert r["cache_bytes_jax_layout"] == roofline.cache_bytes_jax_layout(
                _cfg(arch), configs.SHAPES[shape], MeshShape(("data", "model"), (16, 16)))


# ---------------------------------------------------------------------------
# wire bytes and the fake/real peak
# ---------------------------------------------------------------------------
class _Toy(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.a, self.b = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x, tp):
        return self.b(reduce_from_tp(self.a(copy_to_tp(x, tp)), tp))


def test_wire_bytes_of_a_two_layer_toy_are_the_ring_formulas():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as fc
    from torch.distributed.fsdp import fully_shard

    d, rows, data, model = 64, 8, 4, 2
    with dryrun.fake_world(data * model):
        mesh = make_mesh((data, model), ("data", "model"), "cpu")
        tp = TensorParallel(mesh.get_local_rank("model"), model, mesh.get_group("model"))
        with FakeTensorMode():
            toy = _Toy(d)
            for m in (toy.a, toy.b, toy):
                fully_shard(m, mesh=mesh["data"])
            x = torch.zeros(rows, d, requires_grad=True)
            counter = StepCounter(mesh_dims(mesh))
            with counter:
                toy(x, tp).sum().backward()
                dist.broadcast(torch.zeros(5, 3), 0, group=mesh.get_group("model"))
                fc.wait_tensor(fc.all_reduce(torch.zeros(7), "sum", mesh.get_group("data")))
    hlo = counter.hlo()
    shard = (d * d + d) // data * 4  # one linear's fp32 shard on a data rank
    gather = shard * data * (data - 1) / data  # all-gather: out (g-1)/g
    scatter = shard * (data - 1)  # reduce-scatter: out (g-1)
    act = 2 * rows * d * 4 * (model - 1) / model  # all-reduce: 2 out (g-1)/g
    small = 2 * 7 * 4 * (data - 1) / data
    want = {"all-gather": 4 * gather,  # each layer: forward, and again for its backward
            "reduce-scatter": 2 * scatter, "all-reduce": 2 * act + small,
            "broadcast": 5 * 3 * 4.0}
    assert {k: v for k, v in hlo["coll_breakdown"].items() if ":" not in k} == want
    assert hlo["coll_counts"] == {"all-gather": 4, "reduce-scatter": 2, "all-reduce": 3,
                                  "broadcast": 1}
    assert hlo["coll_by_dim"] == {"data": 4 * gather + 2 * scatter + small,
                                  "model": 2 * act + 60.0}
    assert hlo["coll_bytes"] == sum(want.values())
    assert hlo["dot_flops"] == 2 * 3 * 2 * rows * d * d  # 2 linears: forward, dx, dW


WIRE_LEVERS = {"bf16": {"param_gather_dtype": "bfloat16"}, "packed": {"packed_wire": True},
               "both": {"param_gather_dtype": "bfloat16", "packed_wire": True}}


def test_wire_levers_cut_the_all_gathers_by_the_closed_form():
    """chatglm3-6b's smoke config (fake-quant, remat "none") traced over 4
    data ranks under each FSDP wire format: each layer's FSDP2 group is
    gathered twice (forward, and again for the backward), at 2 B an element
    under bf16; a pinned weight leaves it and moves once, 1 B an element and
    4 B a gathered group (``fsdp_wire.wire_bytes``); the reduce-scatters
    stay fp32, unchanged."""
    from repro_torch.parallel.fsdp_wire import wire_bytes, wire_plan

    data, base = 4, configs.get_smoke_config("chatglm3-6b")
    shapes = {k: tuple(t.shape) for k, t in abstract_params(base).items()}
    packed = dataclasses.replace(base, packed_wire=True)
    pinned, wire = wire_plan(packed, shapes, data)[0], wire_bytes(packed, shapes, data)

    def gathers(names):  # two fp32 gathers of FSDP2's padded shards, (g-1)/g
        total = 0
        for k in names:
            d = fsdp_shard_dim(k, shapes[k], data)
            total += -(-shapes[k][d] // data) * data * math.prod(shapes[k]) // shapes[k][d]
        return 2 * 4 * (data - 1) / data * total

    layers = gathers([k for k in shapes if k.startswith("layers.")])
    masters = gathers(pinned)
    counted = {}
    with dryrun.fake_world(data):
        mesh = make_mesh((data, 1), ("data", "model"), "cpu")
        for lever, upd in (("default", {}), *WIRE_LEVERS.items()):
            cfg = dataclasses.replace(base, **upd)
            counted[lever] = dryrun.trace_step(cfg, 8, 32, 0, mesh, "cpu")["hlo"]["coll_breakdown"]
    dflt = counted["default"]["all-gather"]
    codes = wire["codes"] + wire["scales"]
    want = {"bf16": dflt - layers / 2, "packed": dflt - masters + codes,
            "both": dflt - (layers - masters) / 2 - masters + codes}
    for lever in WIRE_LEVERS:
        got = counted[lever]
        assert got["all-gather"] == pytest.approx(want[lever], rel=1e-12), lever
        assert got["reduce-scatter"] == counted["default"]["reduce-scatter"], lever
        assert got.get("all-gather:u8", 0) == (wire["codes"] if WIRE_LEVERS[lever].get(
            "packed_wire") else 0)
    assert counted["bf16"]["all-gather:bf16"] == layers / 2 and wire["codes"] > 0


@pytest.mark.parametrize("arch", ["chatglm3-6b", "mamba2-370m"])
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_fake_trace_equals_a_real_cpu_run(arch, kind):
    cfg = tp_smoke(configs.get_smoke_config(arch))
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        if kind == "train":
            fake = dryrun.trace_step(cfg, 4, 32, 2, mesh, "cpu", fake=True)
            real = dryrun.trace_step(cfg, 4, 32, 2, mesh, "cpu", fake=False)
        else:
            fake = dryrun.trace_serve(cfg, 2, 32, kind, mesh, "cpu", fake=True)
            real = dryrun.trace_serve(cfg, 2, 32, kind, mesh, "cpu", fake=False)
            if cfg.family == "dense":  # rank 0's K/V: one of the 2 kv heads
                spec = lm_cache_spec(cfg, 2, 32, tp=TensorParallel(0, 2))
                assert fake["cache_bytes"] == sum(math.prod(s) * dt.itemsize
                                                  for s, dt in spec.values())
    for k in ("peak_bytes", "peak_by_kind", "argument_bytes", "output_bytes", "hlo",
              "cache_bytes"):
        assert fake[k] == real[k], (k, fake[k], real[k])


# ---------------------------------------------------------------------------
# K1 and K3 on fake operands
# ---------------------------------------------------------------------------
@pytest.fixture
def no_kernel(monkeypatch):
    """Fail on any reach for a kernel or a device pointer."""
    def library():
        raise AssertionError("build.library() called on fake operands")

    def data_ptr(self):
        raise AssertionError("data_ptr() called on a fake operand")

    monkeypatch.setattr(build, "library", library)
    monkeypatch.setattr(FakeTensor, "data_ptr", data_ptr)


def test_shape_only_k1_and_k3_allocate_and_record_the_card_launch(no_kernel):
    launch.RECORDED.clear()
    before = launch_counts()
    M, K, N, kb = 64, 4096, 1024, 128
    plan = matmul_plan(M, N, K, kb, FMT)
    assert plan.variant == "split"  # 16 tiles < 132 SMs: the ordered split
    counter = StepCounter()
    with FakeTensorMode():
        x = torch.empty(M, K, device="cuda")
        w = torch.empty(N, K, device="cuda")
        with counter:
            xc, xsg, xst = mls_quantize(x, FMT, kb)
            wc, wsg, wst = mls_quantize(w, FMT, kb)
            base = counter.current()
            y = mls_matmul(xc, xsg, xst, wc.t(), wsg.t(), wst, FMT, kb, "nc")
        sc, ssg, sst = quantize_rows_split(x, FMT, kb)
    assert (xc.shape, xc.dtype, xsg.shape, xst.shape) == ((M, K), torch.uint8, (M, K // kb), ())
    assert (wsg.shape, xc.device.type, y.device.type) == ((N, K // kb), "cuda", "cuda")
    assert (y.shape, y.dtype) == ((M, N), torch.float32)
    assert (sc.shape, ssg.shape, sst.shape) == ((M, K), (M, K // kb), ())
    # K3's output and the (G, M, N) fp32 split workspace, both alive at its peak
    assert counter.peak - base == 512 * -(-M * N * 4 // 512) + plan.workspace_bytes
    assert launch_counts() == before  # no kernel launched, none counted
    got = {}
    for key, n in launch.RECORDED.items():
        assert key[1] == "cuda", key  # the card's launch arguments
        got[key[0]] = got.get(key[0], 0) + n
    assert got == {"mls_quantize_rows": 2, "mls_matmul": 1, "mls_quantize_rows_amax": 1,
                   "mls_quantize_rows_codes": 1}
    assert ("mls_matmul", "cuda", M, N, K, kb, "nc", FMT, plan) in launch.RECORDED
    assert ("mls_quantize_rows", "cuda", M, K, kb, "warp", M * K // 4096) in launch.RECORDED
    assert ("mls_quantize_rows", "cuda", N, K, kb, "warp", 264) in launch.RECORDED


def test_fake_operands_plan_as_the_modelled_card(no_kernel):
    # a seed-cache entry whose winner is not the default: (256, 512, 256)
    # "nc" at k_block 128, split with 16-wide tiles on the H100 (default 64)
    M, K, N, kb = 256, 512, 256, 128
    tuned = autotune.seed_cache().get(autotune.cache_key("gemm", (M, K, N), FMT, "nc"), kb)
    default = autotune.default_block_config(autotune.TuneSpec("gemm", (M, K, N), FMT, kb, "nc"))
    assert tuned is not None and tuned != default
    real = torch.zeros(M, K)
    assert autotune.resolve_block_config("gemm", (M, K, N), FMT, "nc", k_block=kb,
                                         **launch.plan_for(real)) == default
    launch.RECORDED.clear()
    with FakeTensorMode():
        x, w = torch.empty(M, K), torch.empty(K, N)
        assert autotune.resolve_block_config("gemm", (M, K, N), FMT, "nc", k_block=kb,
                                             **launch.plan_for(x)) == tuned
        qd_gemm(x, w, None, None, fmt=FMT, gs_fmt=GS_FMT_DEFAULT, k_block=kb, grouping="nc")
    plans = [key[-1] for key in launch.RECORDED if key[0] == "mls_matmul"]
    assert [(p.variant, p.bn) for p in plans] == [(tuned.variant, tuned.bn)]


def test_real_cpu_tensor_takes_the_plain_version(no_kernel):
    gen = np.random.default_rng(0)
    x = torch.from_numpy(gen.standard_normal((8, 256)).astype(np.float32))
    r = torch.from_numpy(gen.integers(0, 256, (8, 256), dtype=np.uint8))
    launch.RECORDED.clear()
    got = mls_quantize(x, FMT, 128, r_u8=r)
    want = quantize_ref(x, FMT, 128, r_u8=r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert list(launch.RECORDED) == [("mls_quantize_rows", "cpu", 8, 256, 128, "warp", 1)]


def test_k2_and_k4_refuse_fake_operands(no_kernel):
    with FakeTensorMode():
        x = torch.empty(64, 256, device="cuda")
        r = torch.empty(64, 256, dtype=torch.uint8, device="cuda")
        with pytest.raises(NotImplementedError, match="dry run"):
            mls_quantize(x, FMT, 128, r_u8=r, grouping="c")
        with pytest.raises(NotImplementedError, match="dry run"):
            quantize_given_scales(x, FMT, torch.ones((), device="cuda"),
                                  torch.ones(1, 2, device="cuda"), 128, r)
        with pytest.raises(NotImplementedError, match="dry run"):
            implicit_conv_forward(torch.empty(2, 16, 8, 8, device="cuda"),
                                  torch.empty(16, 16, 3, 3, device="cuda"), None, None, 1, 1,
                                  fmt=FMT, k_block=144)


# ---------------------------------------------------------------------------
# cells the port does not run
# ---------------------------------------------------------------------------
def test_refused_and_served_cells_are_recorded(tmp_path, capsys):
    for shape in ("train_4k", "decode_32k"):
        r = dryrun.run_cell("yi-34b", shape, False, out_dir=str(tmp_path), verbose=False,
                            cfg_updates={"family": "vision"})
        assert r["status"] == "refused" and "'vision'" in r["reason"]
    r = dryrun.run_cell("chatglm3-6b", "decode_32k", True, out_dir=str(tmp_path),
                        verbose=False, cfg_updates={"n_layers": 2})
    assert r["status"] == "ran" and r["rows"] == 128 // 32 and "microbatch" not in r
    assert r["cache_bytes"] > r["cache_bytes_jax_layout"] > 0 and r["fits"]
    assert json.loads((tmp_path / "chatglm3-6b_decode_32k_2x16x16.json").read_text()) == r
    # sequence parallelism (SP_RULES): JAX's microbatch, the residual stream
    # split over model; an all-reduce is a reduce-scatter plus an all-gather
    from repro.configs import SHAPES as JSHAPES, get_config as jget_config
    from repro.configs import shape_model_config as jshape_model_config
    from repro.launch.specs import choose_microbatch as jchoose_microbatch

    cut = {"n_layers": 2}
    sp = dryrun.run_cell("chatglm3-6b", "train_4k", False, out_dir=str(tmp_path), verbose=False,
                         seq_shard=True, cfg_updates=cut, tag="sp")
    dflt = dryrun.run_cell("chatglm3-6b", "train_4k", False, out_dir=str(tmp_path),
                           verbose=False, cfg_updates=cut)
    jcfg = dataclasses.replace(jshape_model_config(jget_config("chatglm3-6b"),
                                                   JSHAPES["train_4k"]), **cut)
    jmesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((16, 16)))
    assert sp["microbatch"] == jchoose_microbatch(jcfg, JSHAPES["train_4k"], jmesh, True)
    assert (sp["rules"], dflt["rules"]) == ("sp", "default") and sp["status"] == "ran"
    assert sp["memory_by_kind"]["Activation"] < dflt["memory_by_kind"]["Activation"]
    # each collective once (no remat: full remat runs SP's forward gathers
    # again, where DEFAULT's entries move bytes in the backward alone)
    once = {**cut, "remat": "none"}
    sp, dflt = (dryrun.run_cell("chatglm3-6b", "train_4k", False, out_dir=str(tmp_path),
                                verbose=False, seq_shard=on, cfg_updates=once, tag=tag)
                for on, tag in ((True, "sp_once"), (False, "once")))
    model_sp, model_dflt = sp["hlo"]["coll_by_dim"]["model"], dflt["hlo"]["coll_by_dim"]["model"]
    assert abs(model_sp - model_dflt) <= 0.01 * model_dflt
    assert sp["hlo"]["coll_counts"]["reduce-scatter"] > dflt["hlo"]["coll_counts"]["reduce-scatter"]
    assert dryrun.main(["--arch", "yi-34b", "--shape", "prefill_32k", "--mesh", "both",
                        "--out", str(tmp_path)]) == 0
    assert "2 ran, 0 refused, 0 failed, of 2 cells" in capsys.readouterr().out
