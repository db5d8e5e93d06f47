"""Remat "dots" (``repro_torch.models.lm``: JAX's
``dots_with_no_batch_dims_saveable``, ported as a selective-checkpoint
policy, ``lm.dots_policy``).

- chatglm3-6b and mamba2-370m smoke configs under "dots", quantization
  off and on the fake-quant backend: ``lm_loss`` within ``1e-6`` relative
  and each gradient within ``1e-4`` (L2) of JAX's "dots" (jitted
  ``value_and_grad``, key None), the tolerances ``test_torch_lm_train.py``
  holds "full" to.
- The kernels' backend ("pallas", their plain versions here): "dots",
  "full" and "none" give the same loss and gradients bit for bit, and
  "dots" launches what "full" does (K3 runs inside an
  ``autograd.Function`` the policy cannot see, so it is recomputed).
- What "dots" saves on one fake-quant dense layer, by element count,
  against JAX's ``saved_residuals`` of the same layer under its policy:
  JAX keeps the outputs of six of the layer's seven linears, the port all
  seven.  The one more is the MLP's ``w_down`` output, which no backward
  rule reads: JAX's partial evaluation drops it, while PyTorch's
  selective checkpoint stores every output its policy saves (ROADMAP §3).
  On the kernels ("pallas") neither saves a linear's output.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax._src.ad_checkpoint import saved_residuals  # noqa: E402
from torch.utils.checkpoint import (  # noqa: E402
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import launch, reset_launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_lm_train as T  # noqa: E402



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name,backend", [(n, b) for n in ("chatglm3-6b", "mamba2-370m")
                                          for b in ("off", "fake_quant")])
def test_dots_matches_jax(name, backend):
    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    jcfg, params, model = T.pair(name, remat="dots", **over)
    assert jcfg.remat == model.cfg.remat == "dots"
    batch = T.jax_batch(model.cfg)
    T.assert_close(*T.port_loss_and_grads(model, batch), *T.jax_loss_and_grads(jcfg, params, batch))


def test_dots_full_and_none_are_the_same_bits_on_the_kernels():
    cfg = dataclasses.replace(configs.get_smoke_config("chatglm3-6b"), quant_backend="pallas")
    model = lm.init_lm(cfg, seed=1, device="cpu")
    batch = T.jax_batch(cfg)
    out, launched = {}, {}
    for remat in ("none", "full", "dots"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        reset_launch_counts()
        out[remat] = T.port_loss_and_grads(model, batch, key=12345)
        launched[remat] = {k: sum(c for (kernel, *_), c in launch.RECORDED.items() if kernel == k)
                           for k in ("mls_quantize_rows", "mls_matmul")}
        per = 3 if remat == "none" else 4  # the forward again under "full" and "dots"
        linears = 7 * cfg.n_layers  # wq, wk, wv, wo, w_up, w_gate, w_down
        assert launched[remat] == {"mls_quantize_rows": 2 * per * linears,
                                   "mls_matmul": per * linears}, remat
    for remat in ("full", "dots"):
        assert out[remat][0] == out["none"][0]
        for k, g in out["none"][1].items():
            assert torch.equal(out[remat][1][k], g), (remat, k)


def _port_saved_numels(layer, x, qcfg) -> list[int]:
    """Element counts of the outputs ``dots_policy`` saves in one forward
    (an ``mm(a, b)`` or ``addmm(c, a, b)`` output is ``a.rows x b.cols``)."""
    counts = []

    def policy(ctx, op, *args, **kwargs):
        decision = lm.dots_policy(ctx, op, *args, **kwargs)
        if decision == CheckpointPolicy.MUST_SAVE and not ctx.is_recompute:
            a, b = args[-2:]
            counts.append(a.shape[0] * b.shape[1])
        return decision

    checkpoint(layer, x, qcfg, None, use_reentrant=False, context_fn=functools.partial(
        create_selective_checkpoint_contexts, policy))
    return counts


def test_dots_saves_what_jax_saves_on_a_fake_quant_dense_layer():
    import repro.configs as jconfigs
    from repro.models.transformer import apply_block

    jcfg = dataclasses.replace(jconfigs.get_smoke_config("chatglm3-6b"),
                               quant_backend="fake_quant", remat="dots")
    _, params, model = T.pair("chatglm3-6b", quant_backend="fake_quant", remat="dots")
    layer_params = jax.tree.map(lambda a: a[0], params["layers"])
    x = np.random.default_rng(0).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)

    def block(lp, xx):
        return apply_block(lp, xx, jcfg, jcfg.qcfg(), None)[0]

    policy = jax.checkpoint_policies.dots_with_no_batch_dims_saveable
    residuals = saved_residuals(jax.checkpoint(block, policy=policy), layer_params, x)
    jax_dots = sorted(int(np.prod(aval.shape)) for aval, why in residuals
                      if why.startswith("output of") and "(linear)" in why)
    assert len(jax_dots) == 6, residuals
    ours = _port_saved_numels(model.layers[0], torch.from_numpy(x).requires_grad_(),
                              model.cfg.qcfg())
    cfg = model.cfg
    w_down_out = 2 * 16 * cfg.d_model  # the MLP's last linear: read by no backward rule
    assert sorted(ours) == sorted([*jax_dots, w_down_out])

    # on the kernels both save no GEMM output: JAX's pallas_call is not a
    # dot_general, the port's K3 (its plain version here) is opaque
    pcfg = dataclasses.replace(jcfg, quant_backend="pallas")

    def pallas_block(lp, xx):
        return apply_block(lp, xx, pcfg, pcfg.qcfg(), None)[0]

    residuals = saved_residuals(jax.checkpoint(pallas_block, policy=policy), layer_params, x)
    assert not [why for _, why in residuals if why.startswith("output of")], residuals
    model.cfg = dataclasses.replace(cfg, quant_backend="pallas")
    assert _port_saved_numels(model.layers[0], torch.from_numpy(x).requires_grad_(),
                              model.cfg.qcfg()) == []
