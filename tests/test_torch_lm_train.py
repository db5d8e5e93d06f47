"""The port's LM training loss (``repro_torch.models.lm.lm_loss``) and its
gradients against the JAX package's ``lm.lm_loss`` (jitted
``value_and_grad``), with the JAX parameters (``lm_params_from_jax``),
tokens from JAX's ``make_lm_iterator`` as numpy, and ``key=None``
(nearest rounding: the two packages' stochastic streams differ).

- fp32, quantization off and on the fake-quant backend: the smoke
  configs of chatglm3-6b (dense, half rotary), mamba2-370m (ssm),
  zamba2-7b (hybrid: the shared block runs twice) and pixtral-12b (its
  frontend embeddings replace the first positions, which the loss
  masks).  The loss within ``1e-6`` relative (seen: 2.3e-7) and each
  parameter's gradient within ``1e-4`` relative in the L2 norm (seen:
  3.9e-6): torch and XLA sum matmuls, norms and softmaxes in their own
  orders.  At these sizes no fake-quant code moves to its neighbour.
- bf16 compute (chatglm3-6b): XLA's CPU compiler keeps fused bf16
  results in fp32 unless ``xla_allow_excess_precision`` is off, so JAX is
  compiled with it off (as in ``test_torch_lm.py``); then the loss within
  ``1e-6`` relative and the gradients within ``1e-4`` (seen 1.2e-5), and
  the port computing in fp32 misses that bound (the control).
- ``param_gather_dtype="bfloat16"`` (``gather_view``): the layers see
  bf16 weights, so their fp32 masters' gradients are bf16 values (the
  cast's backward), checked, and agree with JAX's within ``2^-8``
  relative, one bf16 ulp (seen 2.3e-4: a few elements round to the other
  neighbour).
- The pallas backend (the port's K1/K3, plain versions here), chatglm3-6b:
  the loss against JAX's pallas model (interpret mode) within ``1e-6``
  relative.  A code flip can keep whole-model gradients apart (seen: 1.6%
  on one weight), so every quantized linear of the step is held bit for
  bit to JAX's ``matmul_qd_ref`` and ``matmul_qd_grads_ref`` on the
  inputs and the error that the step gave it, where the GEMM contracts
  over one scaling group of 128 (so no group sum is reordered; chatglm3's
  smoke GEMMs all do), else within ``(G - 1) eps max|ref|`` for G groups
  (Mamba2's in_proj is 296 wide: its data gradient sums 3 groups); the
  ssm and hybrid configs' linears too.  The step launches K1 six and
  K3 three times per linear without remat, eight and four with it
  (``chip_smoke.lm_train_launches``).
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
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.data import make_lm_iterator as jax_lm_iterator  # noqa: E402
from repro.kernels import matmul_qd_grads_ref, matmul_qd_ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import launch, lowbit_matmul_qd, reset_launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402

EXACT = {"xla_allow_excess_precision": False}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread each, so that the test
    workers sharing the machine do not spin against each other (the
    setting is restored for the worker's next file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(name: str, **overrides):
    """(JAX config, JAX params, the port's model with the same weights)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **overrides)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model


def jax_batch(cfg, b: int = 2, s: int = 16) -> dict[str, np.ndarray]:
    """Step 0 of the JAX package's token stream (with the frontend's
    embeddings where the config has a frontend), as numpy."""
    extras = ()
    if cfg.frontend != "none":
        extras = (("frontend_emb", (b, cfg.frontend_len, cfg.frontend_dim)),)
    nxt, state = jax_lm_iterator(b, s, cfg.vocab, seed=0, extras=extras)
    batch, _ = nxt(state)
    return {k: np.asarray(v) for k, v in batch.items()}


def jax_loss_and_grads(jcfg, params, batch, compiler_options=None):
    """JAX's ``lm_loss`` and its gradients with key None: (loss, the port's
    state_dict of gradients)."""
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None), has_aux=True))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if compiler_options:
        fn = fn.lower(params, jb).compile(compiler_options=compiler_options)
    (loss, _), grads = fn(params, jb)
    return float(loss), lm_params_from_jax(jax.tree.map(np.asarray, grads), jcfg)


def port_loss_and_grads(model, batch, key=None):
    for p in model.parameters():
        p.grad = None
    loss, metrics = lm.lm_loss(model, {k: torch.from_numpy(v) for k, v in batch.items()}, key)
    loss.backward()
    assert set(metrics) == {"ce", "aux"} and float(metrics["aux"]) == 0.0
    return float(loss), {k: p.grad.clone() for k, p in model.named_parameters()}


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def assert_close(loss, grads, ref_loss, ref_grads, loss_tol=1e-6, grad_tol=1e-4):
    assert abs(loss - ref_loss) <= loss_tol * abs(ref_loss), (loss, ref_loss)
    assert set(grads) == set(ref_grads)
    worst = max(((rel(g, ref_grads[k]), k) for k, g in grads.items()))
    assert worst[0] <= grad_tol, worst


CASES = [(name, backend) for name in ("chatglm3-6b", "mamba2-370m", "zamba2-7b", "pixtral-12b")
         for backend in ("off", "fake_quant")]


@pytest.mark.parametrize("name,backend", CASES)
def test_lm_loss_and_grads_match_jax(name, backend):
    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    jcfg, params, model = pair(name, **over)
    batch = jax_batch(model.cfg)
    if model.cfg.frontend != "none":  # the mask leaves out the frontend's positions
        assert model.cfg.frontend_len > 0 and "frontend_emb" in batch
    assert_close(*port_loss_and_grads(model, batch), *jax_loss_and_grads(jcfg, params, batch))


def test_lm_loss_in_bf16_matches_jax_compiled_exactly():
    jcfg, params, model = pair("chatglm3-6b", quant=False, compute_dtype="bfloat16")
    batch = jax_batch(model.cfg)
    ref = jax_loss_and_grads(jcfg, params, batch, EXACT)
    assert_close(*port_loss_and_grads(model, batch), *ref)
    # control: the same weights computing in fp32 miss that bound
    model32 = lm.LM(dataclasses.replace(model.cfg, compute_dtype="float32"))
    model32.load_state_dict(model.state_dict())
    _, grads32 = port_loss_and_grads(model32, batch)
    assert max(rel(g, ref[1][k]) for k, g in grads32.items()) > 1e-3


def test_gather_view_casts_the_layers_inside_the_forward():
    jcfg, params, model = pair("zamba2-7b", quant=False, param_gather_dtype="bfloat16")
    batch = jax_batch(model.cfg)
    loss, grads = port_loss_and_grads(model, batch)
    assert all(p.dtype == torch.float32 for p in model.parameters())  # fp32 masters
    for k, g in grads.items():
        if k.startswith(("layers.", "shared_attn.")):  # the view's cast rounds their grads
            assert torch.equal(g, g.to(torch.bfloat16).float()), k
    assert not torch.equal(grads["emb"], grads["emb"].to(torch.bfloat16).float())
    assert_close(loss, grads, *jax_loss_and_grads(jcfg, params, batch), grad_tol=2.0 ** -8)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _ExactExp2:
    """``jax.numpy`` with an exact ``exp2`` of integer exponents (built from
    the exponent bits): XLA's CPU ``exp2`` is not exact at or below -15
    (ROADMAP queue 3), and the errors of a real step have groups far below
    their tensor's max (as in ``test_torch_zoo.py``)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(e):
        bits = (jnp.round(e).astype(jnp.int32) + 127) << 23
        return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _recorded_linears(model, batch, monkeypatch):
    """(x, w, y, g) of every quantized linear of one training step of the
    port's model, in call order, and the step's (loss, grads)."""
    records = []

    def recording(x, w, key, qcfg):
        assert key is None and qcfg.backend == "quantized"
        y = lowbit_matmul_qd(x, w, key, qcfg)
        rec = {"x": x.detach().clone(), "w": w.detach().clone(), "y": y.detach().clone()}
        y.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        records.append(rec)
        return y

    monkeypatch.setattr(L, "lowbit_matmul_qd", recording)
    out = port_loss_and_grads(model, batch)
    monkeypatch.undo()
    return records, out


def _hold_linears_to_jax(records, qcfg, monkeypatch):
    jcfg = JQuantConfig(fmt=jformats.EMFormat(qcfg.fmt.e, qcfg.fmt.m),
                        gs_fmt=jformats.EMFormat(qcfg.gs_fmt.e, qcfg.gs_fmt.m),
                        grouping=qcfg.grouping, k_block=qcfg.k_block, stochastic=False,
                        backend="pallas")
    monkeypatch.setattr(jq, "jnp", _ExactExp2())
    fwd = jax.jit(lambda x, w: matmul_qd_ref(x, w, None, jcfg))
    bwd = jax.jit(lambda x, w, g: matmul_qd_grads_ref(x, w, g, None, jcfg))
    for i, rec in enumerate(records):
        x, w, g = (jnp.asarray(rec[k].numpy()) for k in ("x", "w", "g"))
        xt, wt = rec["x"].clone().requires_grad_(), rec["w"].clone().requires_grad_()
        y = lowbit_matmul_qd(xt, wt, None, qcfg)
        y.backward(rec["g"])
        np.testing.assert_array_equal(y.detach().numpy(), rec["y"].numpy())
        dx, dw = bwd(x, w, g)
        k, n = rec["w"].shape
        # (result, reference, contraction length): the forward over K, the
        # data gradient over N, the weight gradient over the tokens
        for what, got, want, length in (("y", y.detach(), fwd(x, w), k),
                                         ("dx", xt.grad, dx, n),
                                         ("dw", wt.grad, dw, rec["x"].numel() // k)):
            _check_groups(got.numpy(), np.asarray(want), -(-length // qcfg.k_block),
                          f"linear {i} {what}")


def _check_groups(got, want, groups: int, what: str) -> None:
    """Bit for bit when the GEMM has one scaling group; else within ``(G -
    1) eps max|ref|`` for the G-term group sum (the jnp oracle adds its
    groups with ``jnp.sum``, the port in k order), as in
    ``test_torch_zoo.py``."""
    atol = (groups - 1) * np.finfo(np.float32).eps * float(np.abs(want).max())
    if atol == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


def test_pallas_lm_loss_matches_jax_and_its_linears_are_bit_exact(monkeypatch):
    jcfg, params, model = pair("chatglm3-6b", quant_backend="pallas")
    batch = jax_batch(model.cfg)
    reset_launch_counts()
    records, (loss, grads) = _recorded_linears(model, batch, monkeypatch)
    launched = {k: sum(c for (kernel, *_), c in launch.RECORDED.items() if kernel == k)
                for k in ("mls_quantize_rows", "mls_matmul")}
    want = _chip_smoke().lm_train_launches(model.cfg)
    assert launched == want and len(records) == want["mls_matmul"] // 3
    ref_loss, _ = jax_loss_and_grads(jcfg, params, batch)
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss), (loss, ref_loss)
    _hold_linears_to_jax(records, model.cfg.qcfg(), monkeypatch)


@pytest.mark.parametrize("name", ["mamba2-370m", "zamba2-7b"])
def test_pallas_linears_of_a_step_match_jax(name, monkeypatch):
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant_backend="pallas")
    model = lm.init_lm(cfg, seed=1, device="cpu")
    batch = jax_batch(cfg)
    records, _ = _recorded_linears(model, batch, monkeypatch)
    assert len(records) == _chip_smoke().lm_train_launches(cfg)["mls_matmul"] // 3
    _hold_linears_to_jax(records, cfg.qcfg(), monkeypatch)


@pytest.mark.parametrize("name", ["chatglm3-6b", "zamba2-7b"])
def test_full_remat_recomputes_each_forward_and_launches_the_closed_form(name):
    """Under full remat each dense or Mamba2 layer's linears run their
    forward twice (K1 8 and K3 4 times per linear), the hybrid's shared
    block once (6 and 3); the loss and gradients are the same bits."""
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant_backend="pallas")
    model = lm.init_lm(cfg, seed=1, device="cpu")
    batch = jax_batch(cfg)
    out = {}
    for remat in ("none", "full"):
        model.cfg = dataclasses.replace(cfg, remat=remat)
        reset_launch_counts()
        out[remat] = port_loss_and_grads(model, batch, key=12345)
        launched = {k: sum(c for (kernel, *_), c in launch.RECORDED.items() if kernel == k)
                    for k in ("mls_quantize_rows", "mls_matmul")}
        assert launched == _chip_smoke().lm_train_launches(model.cfg), remat
    assert out["full"][0] == out["none"][0]
    for k, g in out["none"][1].items():
        assert torch.equal(out["full"][1][k], g), k


def test_remat_dots_is_not_ported():
    """Remat "dots" is ported now (``tests/test_torch_remat.py`` holds it to
    JAX's): ``lm_loss`` accepts it, gives "full"'s loss, and refuses an
    unknown policy."""
    model = lm.init_lm(dataclasses.replace(configs.get_smoke_config("chatglm3-6b"),
                                           remat="dots"), device="cpu")
    batch = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    loss = lm.lm_loss(model, batch)[0]
    model.cfg = dataclasses.replace(model.cfg, remat="full")
    assert torch.equal(loss, lm.lm_loss(model, batch)[0])
    model.cfg = dataclasses.replace(model.cfg, remat="some")
    with pytest.raises(ValueError, match="remat"):
        lm.lm_loss(model, batch)
