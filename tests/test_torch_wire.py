"""The FSDP wire formats of the port's launcher: the 2-byte gather
(``param_gather_dtype="bfloat16"``: FSDP2's mixed-precision policy on
every layer, the hybrid's shared block in a group of its own) and the
1-byte gather (``packed_wire``: each pinned fake-quant weight held sharded
on its wire dim and gathered as packed codes, ``parallel.fsdp_wire``), on
a gloo world of 4 CPU processes (2 pods x 2 data, spawned once for the
module).

- **2-byte.**  Two HSDP steps of the dense, hybrid and encoder-decoder
  smoke configs, fake-quant and "pallas", equal one process taking the
  four ranks' slices as microbatches (its layers read the bf16 cast of
  ``models.lm.gather_view``): losses and parameters within 1e-6 (fp32's
  tolerance of ``test_torch_launch.py``: the ranks' gradients add in
  another order), the two pods' shards bit for bit.
- **1-byte.**  The step with ``packed_wire`` equals the same mesh's step
  without it bit for bit (loss, every gradient, the parameters after two
  steps), for dense (its 64-wide in-projections one scaling group that
  spans the split), ssm widened to d_model 256 (16-wide groups, whole on
  each rank; ``wire=0`` and ``wire=1``), the hybrid (the shared block's
  three uses add their gradients before one reduce-scatter) and dense with
  the 2-byte gather too.  One weight's codes gathered over the data group
  equal the JAX package's ``quantize_operand(..., wire=True)`` of the whole
  weight, along either dim.
- **Bytes.**  One step's all-gathers, counted by ``trace_counts.StepCounter``
  at their payload dtype: 1 B an element of each pinned weight and 4 B a
  scaling group it gathers (``fsdp_wire.wire_bytes``), and the fp32
  all-gathers less the pinned weights' two FSDP2 gathers (forward, and
  again for the backward), the reduce-scatters unchanged.
- **Refusals.**  A weight whose data slice is not whole scaling groups
  refuses (``analysis.lint.lint_wire`` and ``launch.train.shard_model``);
  ``packed_wire`` on "pallas" is a warning; a weight gathered over the
  data axis without ``packed_wire``, or with codes wider than a byte,
  raises.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from repro.core import lowbit as jlowbit  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis.lint import lint_wire  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.core.formats import EMFormat  # noqa: E402
from repro_torch.core.lowbit import QuantConfig, Sharded, quantize_operand  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import MeshShape  # noqa: E402
from repro_torch.parallel.fsdp_wire import wire_bytes, wire_plan  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)
CASES = workers.WIRE_BF16_CASES + workers.WIRE_PACKED_CASES


@pytest.fixture(scope="module")
def world():
    """Every rank's results by case, and (``"one process"``) the 2-byte
    cases' one-process references, made while the world runs."""
    started = workers.start_world(workers.wire_worker, 4, CASES)
    refs = {case: _one_process(workers.wire_config(*case)) for case in workers.WIRE_BF16_CASES}
    ranks = workers.finish_world(started)
    return {**{case: [r[case] for r in ranks] for case in (*CASES, "gather")},
            "one process": refs}


def _one_process(cfg):
    """Two microbatch-4 steps over the global batches: the losses and
    parameters."""
    shape = dataclasses.replace(configs.SHAPES["train_4k"], global_batch=workers.TP_BATCH,
                                seq_len=workers.TP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=4))
    model = lm.init_lm(cfg, seed=0, device="cpu")
    opt, data, losses = init(model), workers.tp_batches(cfg), []
    for _ in range(2):
        model, opt, m = step(model, opt, next(data))
        losses.append(m["loss"].item())
    return losses, dict(model.named_parameters())


def _pods_agree(res):
    by_coord = {r["coord"][:2]: r["local"] for r in res}
    for data_i in range(2):
        a, b = by_coord[(0, data_i)], by_coord[(1, data_i)]
        assert all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("case", workers.WIRE_BF16_CASES, ids="-".join)
def test_bf16_gather_steps_match_one_process_microbatches(world, case):
    res = world[case]
    losses, params = world["one process"][case]
    fp32 = (case[0], case[1], "")  # the lever moves the numbers: not the fp32 step's
    if fp32 in world:
        assert any(not torch.equal(res[0]["params"][k], world[fp32][0]["params"][k])
                   for k in params)
    for r in res:
        assert np.allclose(r["losses"], losses, rtol=0, atol=1e-6)
        for k, p in params.items():
            assert (r["params"][k] - p.detach()).abs().max().item() <= 1e-6, k
    _pods_agree(res)


def _packed_pair(case):
    arch, backend, levers = case
    return case, (arch, backend, levers.replace("packed+", "").replace("packed", ""))


@pytest.mark.parametrize("case", [c for c in workers.WIRE_PACKED_CASES if "packed" in c[2]],
                         ids="-".join)
def test_packed_gather_step_equals_unpacked_bit_for_bit(world, case):
    packed, plain = _packed_pair(case)
    for a, b in zip(world[packed], world[plain]):
        assert a["coord"] == b["coord"]
        assert torch.equal(a["loss"], b["loss"]) and a["losses"] == b["losses"]
        assert a["grads"].keys() == b["grads"].keys()
        for k in a["grads"]:
            assert torch.equal(a["grads"][k], b["grads"][k]), k
            assert torch.equal(a["params"][k], b["params"][k]), k
    cfg = workers.wire_config(*packed)
    pinned = wire_plan(cfg, {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}, 2)[0]
    assert world[packed][0]["pinned"] == sorted(k.removesuffix(".w") for k in pinned)
    assert {d for d in pinned.values()} == {0, 1} and not world[plain][0]["pinned"]
    _pods_agree(world[packed])


def test_packed_and_bf16_world_cases_are_distinct(world):
    a = world[("chatglm3-6b", "fake_quant", "packed+bf16")][0]["params"]
    b = world[("chatglm3-6b", "fake_quant", "packed")][0]["params"]
    assert any(not torch.equal(a[k], b[k]) for k in a)


def test_one_step_all_gather_bytes_in_closed_form(world):
    cfg = workers.wire_config("chatglm3-6b", "fake_quant", "packed")
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    pinned = wire_plan(cfg, shapes, 2)[0]
    want = wire_bytes(cfg, shapes, 2)  # one use of each pinned weight (remat "none")
    fp32 = sum(4.0 * shapes[k][0] * shapes[k][1] for k in pinned) / 2  # its gather, (g-1)/g
    for a, b in zip(world[("chatglm3-6b", "fake_quant", "packed")],
                    world[("chatglm3-6b", "fake_quant", "")]):
        got, dflt = a["wire"], b["wire"]
        assert got["all-gather:u8"] == want["codes"] > 0
        assert got["all-gather:f32"] == dflt["all-gather:f32"] - 2 * fp32 + want["scales"]
        assert want["scales"] > 0 and "all-gather:u8" not in dflt
        assert got["reduce-scatter"] == dflt["reduce-scatter"]


def test_gathered_codes_equal_jax_quantize_operand(world):
    from repro.core.formats import FMT_IMAGENET as JFMT
    from repro.core.quantize import GroupSpec as JGroupSpec

    g = world["gather"][0]
    w = g["w"]
    for dim, (unit, s_t) in g["gathered"].items():
        jcfg = jlowbit.QuantConfig(fmt=JFMT, packed_wire=True, wire_fsdp_dim=dim, shard_ways=16)
        spec = QuantConfig(shard_ways=16).matmul_specs((1, 256), tuple(w.shape))[1]
        ju, jst = jlowbit.quantize_operand(jnp.asarray(w.numpy()), jcfg, JGroupSpec(spec.block),
                                           None, 1, wire=True)
        assert np.array_equal(np.asarray(ju, dtype=np.float32), unit.numpy()), dim
        assert float(jst) == s_t.item()
        for r in world["gather"][1:]:
            assert torch.equal(r["gathered"][dim][0], unit)


def test_lint_and_launcher_refuse_weights_that_cannot_move_as_codes():
    ragged = dataclasses.replace(configs.get_smoke_config("chatglm3-6b"), d_model=384,
                                 packed_wire=True)
    lint = lint_wire(ragged, 2)
    assert not lint.ok and "not whole 128-wide scaling groups" in lint.errors[0]
    with pytest.raises(ValueError, match="packed codes cannot be gathered"):
        launcher.shard_model(lm.init_lm(ragged, device="cpu"),
                             MeshShape(launcher.MESH_AXES, (2, 2, 1)))
    ok = dataclasses.replace(configs.get_smoke_config("chatglm3-6b"), packed_wire=True)
    assert lint_wire(ok, 2).ok and not lint_wire(ok, 2).warnings
    assert lint_wire(ok, 3).ok and "FSDP2 gathers their masters" in lint_wire(ok, 3).warnings[0]
    pallas = dataclasses.replace(ok, quant_backend="pallas")
    assert lint_wire(pallas, 2).ok and "'pallas'" in lint_wire(pallas, 2).warnings[0]
    assert wire_plan(pallas, {}, 2) == ({}, [], [])
    # a weight gathered over the data axis moves as codes or not at all
    w = torch.randn(64, 32)
    sh = Sharded(0, ((0, 32),), 64)
    spec = QuantConfig().matmul_specs((1, 64), (64, 32))[1]
    with pytest.raises(ValueError, match="packed codes"):
        quantize_operand(w[:32], QuantConfig(packed_wire=False), spec, None, 1, wire_shard=sh)
    wide = QuantConfig(fmt=EMFormat(1, 7), k_block=1, packed_wire=True)  # 9-bit codes
    with pytest.raises(ValueError, match="at most 8 bits"):
        quantize_operand(w[:32], wide, spec, None, 1, wire_shard=sh)
