"""The rest of the port's ``launch`` against the JAX package's, and the
launcher's HSDP step on a world of gloo processes on the CPU.

- ``choose_microbatch`` equals JAX's on stand-in meshes (JAX reads only
  ``axis_names`` and ``devices.shape``), with and without ``seq_shard``.
- ``batch_specs`` / ``cache_specs`` / ``abstract_params`` (meta tensors)
  have the shapes and dtypes of JAX's ``eval_shape`` stand-ins for every
  arch and shape; tokens are int64 in the port (its index dtype), int32 in
  JAX; the cache's ``pos`` is an int in the port.
- ``roofline``'s analytic terms equal JAX's formulas, with the hardware
  constants factored out (the port's are the H100's, JAX's a TPU's).
- The launcher's HSDP step on 4 gloo ranks (2 pods x 2 data, smoke
  configs, fake-quant, remat "none" and "full"): each rank's loss on its
  slice and the gradients (averaged by FSDP2 over the world) equal one
  process running the same four slices as microbatches (the quantizer's
  tensor scales are per local tensor, so a slice is the unit of the
  computation), and, unquantized, one process over the whole batch; and
  two steps of ``launch.train.main --multi-pod`` leave the parameters of
  one process taking microbatch-4 steps, identical across pods.  The
  tolerance is fp32's: the reduction adds the ranks' gradients in another
  order than the microbatch loop, 1e-5 of the largest gradient, 1e-6 on
  the parameters and losses (seen: below 1e-8).
- ``--model-axis`` > 1 on a family other than dense, a mesh with a
  ``model`` axis > 1 for one, and ``--multi-pod`` or ``--model-axis``
  without torchrun raise (the dense family's tensor parallelism is
  ``tests/test_torch_tensor_parallel.py``'s).
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import roofline as jroofline  # noqa: E402
from repro.launch import specs as jlspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.data import make_lm_iterator  # noqa: E402
from repro_torch.launch import roofline, specs  # noqa: E402
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel import MeshShape  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

torch.set_num_threads(1)
ARCHS = sorted(configs.ARCHS)
MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (1, 1)), (("pod", "data", "model"), (2, 4, 8))]


def _meshes():
    for names, shape in MESHES:
        yield MeshShape(names, shape), types.SimpleNamespace(axis_names=names,
                                                             devices=np.empty(shape))


def _cells(name):
    cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
    for shape in configs.runnable_shapes(cfg):
        yield (configs.shape_model_config(cfg, shape), shape,
               jconfigs.shape_model_config(jcfg, jconfigs.SHAPES[shape.name]),
               jconfigs.SHAPES[shape.name])


@pytest.mark.parametrize("name", ARCHS)
def test_choose_microbatch_matches_jax_on_every_mesh(name):
    for cfg, shape, jcfg, jshape in _cells(name):
        for ours, ref in _meshes():
            for seq_shard in (False, True):
                assert specs.choose_microbatch(cfg, shape, ours, seq_shard) == \
                    jlspecs.choose_microbatch(jcfg, jshape, ref, seq_shard), (shape.name, ref)


def _same(t: torch.Tensor, sds) -> bool:
    dt = {"int32": torch.int64}.get(str(sds.dtype), getattr(torch, str(sds.dtype)))
    return t.device.type == "meta" and tuple(t.shape) == tuple(sds.shape) and t.dtype == dt


@pytest.mark.parametrize("name", ARCHS)
def test_abstract_inputs_match_jax(name):
    for cfg, shape, jcfg, jshape in _cells(name):
        got, want = specs.batch_specs(cfg, shape), jlspecs.batch_specs(jcfg, jshape)
        assert got.keys() == want.keys() and all(_same(got[k], want[k]) for k in got)
        if shape.kind == "decode":
            got, want = specs.cache_specs(cfg, shape), jlspecs.cache_specs(jcfg, jshape)
            assert got.keys() == want.keys() and got["pos"] == 0
            assert all(_same(got[k], want[k]) for k in got if k != "pos"), shape.name
        else:
            with pytest.raises(ValueError, match="decode"):
                specs.cache_specs(cfg, shape)
    ours = specs.abstract_params(configs.get_config(name))
    want = jlspecs.abstract_params(jconfigs.get_config(name))
    jleaves = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sum(t.numel() for t in ours.values()) == sum(int(np.prod(v.shape)) for _, v in jleaves)
    assert all(t.device.type == "meta" and t.dtype == torch.float32 for t in ours.values())
    opt = specs.abstract_opt_state(ours, make_train_step(RunConfig(
        model=configs.get_config(name), shape=configs.SHAPES["train_4k"]))[1])
    assert opt.mu.keys() == ours.keys() and all(v.device.type == "meta" for v in opt.nu.values())


@pytest.mark.parametrize("name", ARCHS)
def test_roofline_terms_match_jax_with_the_constants_factored_out(name, monkeypatch):
    for cfg, shape, jcfg, jshape in _cells(name):
        assert roofline.model_flops(cfg, shape) == jroofline.model_flops(jcfg, jshape)
        assert roofline.expected_hlo_flops(cfg, shape) == jroofline.expected_hlo_flops(jcfg,
                                                                                         jshape)
        for ours, ref in _meshes():
            assert roofline.hbm_bytes(cfg, shape, ours) == jroofline.hbm_bytes(jcfg, jshape, ref)
            assert roofline.cache_bytes_jax_layout(cfg, shape, ours) == \
                jroofline._cache_bytes(jcfg, jshape, ref)
            record = {"hlo": {"dot_flops": 3.5e15, "coll_bytes": 2.0e10}, "microbatch": 0}
            got = roofline.roofline_terms(cfg, shape, ours, record)
            want = jroofline.roofline_terms(jcfg, jshape, ref, record)
            assert got["compute_s"] * roofline.PEAK_FLOPS == pytest.approx(
                want["compute_s"] * jroofline.PEAK_FLOPS, rel=1e-12)
            assert got["memory_s"] * roofline.HBM_BW == pytest.approx(
                want["memory_s"] * jroofline.HBM_BW, rel=1e-12)
            assert got["collective_s"] * roofline.LINK_BW == pytest.approx(
                want["collective_s"] * jroofline.ICI_BW, rel=1e-12)
    monkeypatch.setattr(roofline, "PEAK_FLOPS", jroofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", jroofline.HBM_BW)
    monkeypatch.setattr(roofline, "LINK_BW", jroofline.ICI_BW)
    for cfg, shape, jcfg, jshape in _cells(name):
        for ours, ref in _meshes():
            record = {"hlo": {"dot_flops": 1e14, "coll_bytes": 1e9}}
            assert roofline.roofline_terms(cfg, shape, ours, record) == \
                jroofline.roofline_terms(jcfg, jshape, ref, record)


def test_h100_constants():
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (989e12, 3.35e12, 450e9)


# ---------------------------------------------------------------------------
# the launcher's HSDP step
# ---------------------------------------------------------------------------
HSDP_CASES = [("chatglm3-6b", True, "none"), ("mamba2-370m", True, "full"),
              ("chatglm3-6b", False, "full")]


@pytest.fixture(scope="module")
def hsdp():
    ranks = workers.run_world(workers.hsdp_worker, 4, HSDP_CASES)
    return {case: [r[case] for r in ranks] for case in HSDP_CASES}


def _reference(arch, quant, remat, n_parts):
    """One process: the grads of the same loss over the four slices as
    microbatches (or the whole batch at ``n_parts`` 1), mean of losses."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), quant=quant, remat=remat)
    model = lm.init_lm(cfg, seed=0, device="cpu")
    batch = next(make_lm_iterator(batch=workers.HSDP_BATCH, seq=workers.HSDP_SEQ,
                                  vocab=cfg.vocab, device="cpu"))
    losses = []
    for part in batch["tokens"].chunk(n_parts):
        loss, _ = model.loss({"tokens": part}, 7)
        (loss / n_parts).backward()
        losses.append(loss.detach())
    return losses, {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("case", HSDP_CASES, ids=lambda c: f"{c[0]}-{'q' if c[1] else 'fp32'}"
                         f"-{c[2]}")
def test_hsdp_gradients_match_one_process(hsdp, case):
    from torch.distributed.tensor import Replicate, Shard

    res = hsdp[case]
    for n_parts in ((4,) if case[1] else (4, 1)):
        losses, grads = _reference(*case, n_parts)
        for r in res:
            pod, data = r["coord"][:2]
            if n_parts == 4:
                assert abs(r["loss"].item() - losses[pod * 2 + data].item()) <= 1e-6
            for k, g in grads.items():
                tol = 1e-5 * g.abs().max().item() + 1e-12
                assert (r["grads"][k] - g).abs().max().item() <= tol, (k, n_parts)
        for k, place in res[0]["placements"].items():  # the rule's dim over data 2
            assert place == (Replicate(), Shard(launcher.fsdp_shard_dim(k, grads[k].shape, 2))), k


def test_launcher_hsdp_steps_match_microbatch_steps_and_pods_agree(hsdp):
    case = HSDP_CASES[0]
    res = hsdp[case]
    cfg = configs.get_smoke_config(case[0])
    shape = dataclasses.replace(configs.SHAPES["train_4k"], global_batch=workers.HSDP_BATCH,
                                seq_len=workers.HSDP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=4))
    model = lm.init_lm(cfg, seed=0, device="cpu")
    opt = init(model)
    data = make_lm_iterator(batch=workers.HSDP_BATCH, seq=workers.HSDP_SEQ, vocab=cfg.vocab,
                            device="cpu")
    losses = []
    for _ in range(2):
        model, opt, m = step(model, opt, next(data))
        losses.append(m["loss"].item())
    for r in res:
        assert r["world"] == 4
        assert np.allclose(r["losses"], losses, rtol=0, atol=1e-6)
        for k, p in model.named_parameters():
            assert (r["params"][k] - p.detach()).abs().max().item() <= 1e-6, k
    by_coord = {r["coord"][:2]: r["local"] for r in res}
    for data_i in range(2):  # the two pods hold the same shards, bit for bit
        a, b = by_coord[(0, data_i)], by_coord[(1, data_i)]
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_launcher_refuses_tensor_parallelism_and_multi_pod_without_a_world(monkeypatch):
    """A model axis or --multi-pod without a world raises, for every family
    (each trains tensor-parallel under torchrun); a 2-byte parameter gather
    under FSDP2 is laid out (on a fake world of 2 pods x 2 data): every
    layer's group gathers bf16, the root's (embeddings, head, final norm)
    fp32."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_mesh

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu", "--steps", "1"]
    other = ["--arch", "moonshot-v1-16b-a3b"] + argv[2:]
    with pytest.raises(ValueError, match="torchrun"):
        launcher.main(other + ["--multi-pod", "--model-axis", "2"])
    bf16 = dataclasses.replace(configs.get_smoke_config("moonshot-v1-16b-a3b"),
                               param_gather_dtype="bfloat16")
    with dryrun.fake_world(4):
        model = launcher.shard_model(lm.init_lm(bf16, device="cpu"),
                                     make_mesh((2, 2, 1), launcher.MESH_AXES, "cpu"))
        assert all(isinstance(p, DTensor) and p.dtype == torch.float32
                   for p in model.parameters())
        for layer in model.layers:
            layer.unshard()
            assert {p.dtype for p in layer.parameters()} == {torch.bfloat16}
            layer.reshard()
        model.unshard()
        assert {p.dtype for k, p in model.named_parameters()
                if not k.startswith("layers.")} == {torch.float32}
        model.reshard()
    with pytest.raises(ValueError, match="torchrun"):
        launcher.main(argv + ["--multi-pod"])
    with pytest.raises(ValueError, match="torchrun"):
        launcher.main(argv + ["--model-axis", "2"])
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        from repro_torch.launch.mesh import make_mesh

        make_mesh((2, 2), ("pod", "data"), "cpu")
