"""Tensor parallelism over the ``model`` axis for the encdec family
(``repro_torch.parallel.tensor``: the encoder's blocks, the decoder's
self-attention, cross-attention and MLP by the dense rules, the
cross-attention's ``wk``/``wv`` column-parallel over the kv heads on the
encoder's output; ``frontend_proj`` replicated) on worlds of gloo
processes on the CPU, against the unsharded port and the JAX package's
unsharded ``lm_loss``.

The model is seamless-m4t-medium's smoke config widened as the launcher
widens it under ``--model-axis`` (``launch.train.tp_smoke``: 128-wide
heads, 2 kv heads, an ungated d_ff of 640 = 5 scaling groups), fp32,
unquantized, on the fake-quant backend and on the quantized one (K1/K3's
plain versions), stochastic rounding from one key; every batch carries
``src_emb`` (12 frames).

- World 2, model 2, each backend: the cross-attention's ``wk`` and ``wv``
  on a source of 12 frames give the unsharded linear's output pieces and
  weight-gradient pieces bit for bit, and the source's gradient (each
  rank's kv heads add a part, summed by ``copy_to_tp``) within ``(G_r +
  1) eps max|ref|``, ``G_r`` the rank's groups of 128 (unquantized: its
  products).
- The whole step at model 2 and at model 4 (the 2 kv heads replicated
  there) against the unsharded port: the loss within 1e-6 relative and
  each gradient slice within 1e-5 relative in the L2 norm, on every
  backend; the quantized one's launches per rank equal
  ``chip_smoke.lm_train_launches(cfg, model_axis=m)``.  The quantized
  steps feed each linear (the encoder's too) the unsharded step's input
  and output gradient (``torch_dist_workers._linear_feed``): a
  row-parallel sum's order can move a stochastic-rounding code.
- The unquantized step on the JAX package's parameters against the JAX
  package's unsharded ``lm_loss`` and ``jax.grad`` on the same batch and
  ``src_emb``: within 1e-4.
- World 4 = data 2 x model 2: two steps through
  ``launch.train.shard_model`` (HSDP over the data axis) and the train
  step (the launcher's stream carries no ``src_emb``, as JAX's does not)
  equal two microbatch-2 steps of the model-only world 2 on the same
  global batches (losses and parameters within 1e-6).
- ``tp_layout`` of the full config at model 2 (vocabulary 256206 as
  128103 a rank, ``frontend_proj`` replicated) and at model 4, where the
  vocabulary stays replicated (4 does not divide it); K1's split entries and K3 proved at its rank shapes (the
  cross-attention's over 4096 source frames)
  (``tests/test_torch_tensor_parallel_serve.py`` serves a tensor-parallel
  encoder-decoder).
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import torch_dist_workers as workers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.parallel.tensor import tp_layout  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
ARCH = workers.ENCDEC_ARCH


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's unquantized loss and gradients on the workers' batch (its
    ``src_emb`` too) and its parameters, each as the port's state dict."""
    cfg = workers.smoke_tp_config(ARCH, "off")
    over = {k: getattr(cfg, k) for k in ("head_dim", "n_kv_heads", "d_ff")}
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(ARCH), **over, quant=False)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    batch = {k: jnp.asarray(v.numpy()) for k, v in workers.tp_batch(cfg, 2).items()}
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None), has_aux=True))
    (loss, _), grads = fn(params, batch)
    return dict(state=lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
                loss=float(loss), grads=lm_params_from_jax(jax.tree.map(np.asarray, grads), cfg))


@pytest.fixture(scope="module")
def tp2(jax_ref):
    return workers.run_world(workers.encdec_tp2_worker, 2, jax_ref["state"])


@pytest.fixture(scope="module")
def tp4():
    return workers.run_world(workers.encdec_tp4_worker, 4)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


XATTN = [(backend, name) for backend in workers.TP_BACKENDS for name in ("wk", "wv")]


@pytest.mark.parametrize("backend,name", XATTN, ids=lambda v: str(v))
def test_cross_attention_kv_is_column_parallel_over_the_source(tp2, backend, name):
    for rank, r in enumerate(tp2):
        (y, dmem, dw), (yt, dmemt, dwt, pieces) = r["xattn"][backend][name]
        (a, b), = pieces
        assert (a, b) == ((0, 128), (128, 256))[rank]  # one of the 2 kv heads of 128
        assert yt.shape[1] == workers.TP_SRC
        assert torch.equal(yt, y[..., a:b]) and torch.equal(dwt, dw[:, a:b])
        width = 1 if backend == "off" else 128
        tol = (-(-(b - a) // width) + 1) * EPS * dmem.abs().max().item()
        assert (dmemt - dmem).abs().max().item() <= tol


def _hold_step(s, rank, loss_tol=1e-6, grad_tol=1e-5):
    assert abs(s["loss"].item() - s["ref_loss"].item()) <= loss_tol * abs(s["ref_loss"].item())
    for k, g in s["grads"].items():
        ref = s["ref_grads"][k]
        if k in s["layout"]:
            ref = s["layout"][k].take(ref, rank)
        assert g.shape == ref.shape and _rel(g, ref) <= grad_tol, k


@pytest.mark.parametrize("backend", workers.TP_BACKENDS)
def test_tp_step_matches_the_unsharded_port_at_model_2(tp2, backend):
    for rank, r in enumerate(tp2):
        s = r["steps"][backend]
        assert {"emb", "lm_head", "enc_layers.0.attn.wq.w", "enc_layers.1.mlp.w_down.w",
                "layers.0.xattn.wk.w", "layers.1.xattn.wo.w"} <= set(s["layout"])
        assert not any(k.startswith("frontend_proj") for k in s["layout"])
        _hold_step(s, rank)


@pytest.mark.parametrize("backend", workers.TP_BACKENDS)
def test_model_4_replicates_the_kv_heads_and_matches_the_unsharded_port(tp4, backend):
    for rank, r in enumerate(tp4):
        s = r["steps"][backend]
        assert "layers.0.xattn.wk.w" not in s["layout"]  # 2 kv heads over 4 ranks
        assert "enc_layers.0.attn.wv.w" not in s["layout"]
        _hold_step(s, rank)


@pytest.mark.parametrize("model_axis", [2, 4])
def test_tp_launches_per_rank_equal_the_closed_form(tp2, tp4, model_axis):
    cfg = workers.smoke_tp_config(ARCH, "pallas")
    want = _chip_smoke().lm_train_launches(cfg, model_axis=model_axis)
    for r in (tp2 if model_axis == 2 else tp4):
        assert r["steps"]["pallas"]["launches"] == want
        assert r["steps"]["fake_quant"]["launches"] == {}


def test_tp_step_matches_jax_unsharded_loss_and_grads(tp2, jax_ref):
    for rank, r in enumerate(tp2):
        s = r["jax"]
        assert abs(s["loss"].item() - jax_ref["loss"]) <= 1e-4 * abs(jax_ref["loss"])
        for k, g in s["grads"].items():
            want = jax_ref["grads"][k]
            if k in s["layout"]:
                want = s["layout"][k].take(want, rank)
            assert _rel(g, want) <= 1e-4, k


def test_hsdp_times_tp_equals_the_microbatched_model_only_step(tp2, tp4):
    for r in tp4:
        data, model = r["coord"]
        got, ref = r["hsdp"], tp2[model]["microbatch"]
        assert got["world"] == 4
        assert np.allclose(got["losses"], ref["losses"], rtol=0, atol=1e-6)
        for k, p in ref["params"].items():
            assert (got["params"][k] - p).abs().max().item() <= 1e-6, k


def test_full_config_layout_at_model_2_and_the_vocabulary_at_4():
    cfg = dataclasses.replace(configs.get_config(ARCH), quant_backend="pallas")
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    two = tp_layout(cfg, shapes, 2)
    assert two["emb"].bounds == ((0, 128103), (128103, 256206))
    assert two["lm_head"].bounds == two["emb"].bounds
    assert not any(k.startswith("frontend_proj") for k in two)
    for prefix in ("enc_layers.11.", "layers.11."):
        assert two[f"{prefix}attn.wq.w"].bounds == ((0, 512), (512, 1024))  # 8 heads of 64
        assert two[f"{prefix}mlp.w_up.w"].bounds == ((0, 2048), (2048, 4096))
        assert two[f"{prefix}mlp.w_down.w"].dim == 0
    assert two["layers.0.xattn.wk.w"].bounds == ((0, 512), (512, 1024))
    assert two["layers.0.xattn.wo.w"].dim == 0
    four = tp_layout(cfg, shapes, 4)  # 256206 over 4: the vocabulary stays whole
    assert "emb" not in four and "lm_head" not in four
    assert four["layers.0.attn.wq.w"].bounds == ((0, 256), (256, 512), (512, 768), (768, 1024))
    assert four["layers.0.mlp.w_up.w"].bounds[3] == (3072, 4096)


def test_split_k1_and_k3_launch_specs_prove_at_seamless_tensor_parallel_shapes():
    from repro_torch.analysis.kernel_verify import (
        TP_AUDIT_ENCDEC, tensor_parallel_specs, verify_specs)

    arch, m, tokens = TP_AUDIT_ENCDEC
    specs = tensor_parallel_specs(configs.get_config(arch), m, tokens)
    report = verify_specs("tp", specs)
    assert report.ok, report.first_violation()
    assert any(s.kernel.startswith("mls_matmul") for s, _ in specs)
    shapes = {s.operands[0].shape for s, _ in specs if s.kernel.startswith("quantize_groups")}
    # w_up's w^T (2048 of d_ff 4096 a rank), w_down's x, the K/V error over 4096 frames
    assert {(2048, 1024), (4096, 2048), (4096, 512)} <= shapes
