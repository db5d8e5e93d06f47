"""The port's encoder-decoder family (seamless-m4t; ``_encoder``,
``XDecBlock`` and ``_xdec`` in ``repro_torch.models.lm``) against the JAX
package's ``_encoder_apply`` / ``_xdec_scan`` / ``lm_loss`` / ``prefill`` /
``decode_step`` (jitted), with the JAX parameters (``init_lm`` through
``lm_params_from_jax``) and inputs made by numpy from a seed; and the
serving path and the train step of the two new families on the CPU.

- The encoder's and the decoder's layer stacks on the same inputs,
  unquantized: within ``1e-5 max(1, max|ref|)`` (seen 4.5e-8; matmuls,
  norms and softmaxes sum in other orders).  On
  fake-quant with nearest rounding one ulp of a LayerNorm before a
  quantizer moves an element to the neighbouring code (seen: 61 of the
  decoder's 2048 outputs, by up to 4.6e-4), so the stacks are held to
  ``1e-3 max(1, max|ref|)``, as ``test_torch_lm.py`` holds whole
  quantized models, and every fake-quant linear of a training step is
  held to JAX's ``lowbit_matmul`` on the inputs and the error the step
  gave it: the forward bit for bit (each smoke GEMM contracts over one
  scaling group, so its sum is exact), the two gradients within ``1e-6``
  relative (the weight gradient sums rows of different scales).
- ``lm_loss`` and its gradients (key None): unquantized, the loss within
  ``1e-6`` relative and each gradient within ``1e-4`` relative in the L2
  norm, as ``test_torch_lm_train.py`` holds the other families; on
  fake-quant, where such a flip happens in this step (seen: loss 4.6e-6,
  the encoder's gradients 4.1%), ``1e-5`` and ``5e-2``, the per-linear
  check above holding the arithmetic.  The loss trains on every target:
  the frontend-prefix mask of the decoder-only families is not the
  encoder-decoder's (JAX's ``family != "encdec"`` clause), and the CE
  with it (the parent's rule) misses JAX's unquantized loss by more than
  100 times the tolerance (seen 7.8e-4 relative).
- Prefill plus decode against the teacher-forced forward of the three new
  configs (unquantized; the MoE at capacity 8, so no token drops in
  either), within ``5e-4``, the bound of
  ``tests/test_decode_consistency.py``.
- ``quant_backend="pallas"``: seamless's smoke model served on the port's
  K1/K3 (their plain versions here) against JAX's pallas model (interpret
  mode) within ``1e-3 max(1, max|ref|)`` (as ``test_torch_lm.py``; seen
  1.5e-7, no code flip), with
  the launches of ``chip_smoke.serve_linears`` at prefill (encoder and
  decoder) and decode (the decoder: the cross-attention's K/V were made at
  prefill, unquantized).
- ``ServeEngine`` generates and ``make_train_step`` trains the new
  families on the CPU (the batch carries ``src_emb`` for the
  encoder-decoder; the MoE's aux loss is in the step's metrics).
- ``convert.lm_params_from_jax`` of seamless's smoke tree: the encoder's
  stack unstacked on ``enc_layers``, every leaf in the ``state_dict`` with
  its shape, none left over.
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
from repro.core import lowbit_matmul as jax_lowbit_matmul  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import SHAPES, RunConfig  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import launch, reset_launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NAME = "seamless-m4t-medium"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that the test workers sharing
    the machine do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(name: str = NAME, **over):
    """(JAX config, JAX params, the port's model with the same weights)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **over)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **over)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model


def batch_of(cfg, b=2, s=16, src=12, seed=1) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    if cfg.family == "encdec":
        out["src_emb"] = rng.standard_normal((b, src, cfg.frontend_dim)).astype(np.float32)
    return out


def as_torch(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if k == "tokens" else torch.from_numpy(v)
            for k, v in batch.items()}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _close(got, ref, tol):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=tol * max(1.0, np.abs(ref).max()))


@pytest.mark.parametrize("backend", ["off", "fake_quant"])
def test_encoder_and_decoder_stacks_match_jax(backend):
    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    jcfg, params, model = pair(**over)
    batch = batch_of(model.cfg)
    jq = jcfg.qcfg()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    memory = jax.jit(lambda p, b: jlm._encoder_apply(p, b, jcfg, jq, None))(params, jb)
    x = jax.jit(lambda p, b: jlm.embed(p, b, jcfg))(params, jb)
    ref = jax.jit(lambda p, x, m: jlm._xdec_scan(p, x, jcfg, jq, None, m)[0])(params, x, memory)
    qcfg = model.cfg.qcfg()
    with torch.no_grad():
        got_memory = lm._encoder(model, as_torch(batch), qcfg, None)
        got = lm._xdec(model, torch.from_numpy(np.asarray(x)), qcfg, None,
                       torch.from_numpy(np.asarray(memory)))
    tol = 1e-5 if backend == "off" else 1e-3
    _close(got_memory, memory, tol)
    _close(got, ref, tol)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _recorded_linears(model, batch, monkeypatch):
    """(x, w, y, g) of every fake-quant linear of one training step of the
    port's model (key None), and the step's (loss, aux, grads)."""
    records = []
    port_linear = L.lowbit_matmul

    def recording(x, w, key, qcfg):
        y = port_linear(x, w, key, qcfg)
        rec = {"x": x.detach().clone(), "w": w.detach().clone(), "y": y.detach().clone()}
        y.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        records.append(rec)
        return y

    monkeypatch.setattr(L, "lowbit_matmul", recording)
    loss, metrics = lm.lm_loss(model, as_torch(batch))
    loss.backward()
    monkeypatch.undo()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return records, float(loss.detach()), float(metrics["aux"]), grads


def _hold_linears_to_jax(records, jq, qcfg):
    fwd = jax.jit(lambda x, w: jax_lowbit_matmul(x, w, None, jq))
    bwd = jax.jit(lambda x, w, g: jax.vjp(lambda a, b: jax_lowbit_matmul(a, b, None, jq),
                                          x, w)[1](g))
    for i, rec in enumerate(records):
        x, w, g = (jnp.asarray(rec[k].numpy()) for k in ("x", "w", "g"))
        assert rec["w"].shape[0] <= jq.k_block  # one scaling group: an exact sum
        np.testing.assert_array_equal(rec["y"].numpy(), np.asarray(fwd(x, w)), f"linear {i}")
        xt, wt = rec["x"].clone().requires_grad_(), rec["w"].clone().requires_grad_()
        L.lowbit_matmul(xt, wt, None, qcfg).backward(rec["g"])
        for got, want in zip((xt.grad, wt.grad), bwd(x, w, g)):
            assert _rel(got, torch.from_numpy(np.asarray(want))) <= 1e-6, f"linear {i}"


@pytest.mark.parametrize("backend", ["off", "fake_quant"])
def test_lm_loss_and_grads_match_jax_and_train_every_target(backend, monkeypatch):
    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    jcfg, params, model = pair(**over)
    cfg = model.cfg
    assert cfg.frontend != "none" and cfg.frontend_len > 0  # the decoder-only rule would mask
    batch = batch_of(cfg)
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None), has_aux=True))
    (ref_loss, _), ref_grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    ref_loss = float(ref_loss)
    ref_grads = lm_params_from_jax(jax.tree.map(np.asarray, ref_grads), jcfg)
    records, loss, aux, grads = _recorded_linears(model, batch, monkeypatch)
    loss_tol, grad_tol = (1e-6, 1e-4) if backend == "off" else (1e-5, 5e-2)
    assert abs(loss - ref_loss) <= loss_tol * abs(ref_loss)
    assert aux == 0.0
    assert set(grads) == set(ref_grads)
    worst = max((_rel(g, ref_grads[k]), k) for k, g in grads.items())
    assert worst[0] <= grad_tol, worst
    # 2 encoder layers x 6 linears, 2 decoder layers x 10 (cross K/V quantized)
    assert len(records) == (0 if backend == "off" else 32)
    if records:
        _hold_linears_to_jax(records, jcfg.qcfg(), cfg.qcfg())
    if backend != "off":
        return
    # control: the CE with the decoder-only families' prefix mask
    with torch.no_grad():
        logits = model(as_torch(batch))[:, :-1].double()
    targets = torch.from_numpy(batch["tokens"][:, 1:]).long()
    nll = torch.logsumexp(logits, -1) - torch.gather(logits, -1, targets[..., None])[..., 0]
    masked = float(nll[:, cfg.frontend_len:].mean())
    assert abs(masked - ref_loss) > 100 * loss_tol * abs(ref_loss)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", NAME])
def test_decode_matches_teacher_forced_forward(name):
    over = {"quant": False}
    if configs.get_smoke_config(name).family == "moe":
        over["capacity_factor"] = 8.0  # no drops: capacity depends on the length
    cfg = dataclasses.replace(configs.get_smoke_config(name), **over)
    model = lm.init_lm(cfg, 0, "cpu")
    batch = as_torch(batch_of(cfg, seed=3))
    toks = batch["tokens"]
    with torch.no_grad():
        ref = model(batch)
    pre = dict(batch, tokens=toks[:, :8])
    logits, cache = lm.prefill(model, pre, max_len=32)
    errs = [float((logits - ref[:, 7]).abs().max())]
    for i in range(8, 16):
        logits, cache = lm.decode_step(model, cache, toks[:, i:i + 1])
        errs.append(float((logits - ref[:, i]).abs().max()))
    assert max(errs) < 5e-4, errs


def test_pallas_model_serves_like_jax_and_launches_the_closed_form():
    jcfg, params, model = pair(quant_backend="pallas")
    batch = batch_of(model.cfg, s=10)
    pre = {"tokens": batch["tokens"][:, :8], "src_emb": batch["src_emb"]}
    jl, jc = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, 16))(
        params, {k: jnp.asarray(v) for k, v in pre.items()})
    jdec = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))

    def counted():
        return {k: sum(c for (kernel, *_), c in launch.RECORDED.items() if kernel == k)
                for k in ("mls_quantize_rows", "mls_matmul")}  # the plain versions' records

    reset_launch_counts()
    tl, tc = lm.prefill(model, as_torch(pre), 16)
    at_prefill = counted()
    assert tc["xk"].shape[2] == 12  # the cache holds the source's length
    refs, gots = [np.asarray(jl)], [tl.numpy()]
    toks = batch["tokens"]
    for i in (8, 9):
        jl, jc = jdec(params, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = lm.decode_step(model, tc, torch.from_numpy(toks[:, i:i + 1]).long())
        refs.append(np.asarray(jl))
        gots.append(tl.numpy())
    smoke = _chip_smoke()
    n_pre, n_dec = smoke.serve_linears(model.cfg, prefill=True), smoke.serve_linears(model.cfg)
    assert at_prefill == {"mls_quantize_rows": 2 * n_pre, "mls_matmul": n_pre}
    assert counted() == {"mls_quantize_rows": 2 * (n_pre + 2 * n_dec),
                         "mls_matmul": n_pre + 2 * n_dec}
    for r, g in zip(refs, gots):
        _close(g, r, 1e-3)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", NAME])
def test_serve_engine_and_train_step_run_the_new_families(name):
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant_backend="pallas")
    model = lm.init_lm(cfg, 0, "cpu")
    prompts = as_torch(batch_of(cfg, s=6, seed=2))
    engine = ServeEngine(cfg, model, max_len=16, device="cpu")
    out = engine.generate(prompts, 4)
    assert out.shape == (2, 4) and torch.equal(out, engine.generate(prompts, 4))
    step, init = make_train_step(RunConfig(model=cfg, shape=SHAPES["train_4k"]))
    opt = init(model)
    for seed in (4, 5):
        model, opt, metrics = step(model, opt, as_torch(batch_of(cfg, s=8, seed=seed)))
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert (float(metrics["aux"]) > 0) == (cfg.family == "moe")


def test_lm_params_from_jax_round_trip():
    jcfg, cfg = jconfigs.get_smoke_config(NAME), configs.get_smoke_config(NAME)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    sd = lm_params_from_jax(tree, cfg)
    model = lm.LM(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in jax.tree.leaves(tree))
    model.load_state_dict(sd)  # strict: none left over, none missing
    np.testing.assert_array_equal(sd["enc_layers.1.attn.wq.w"].numpy(),
                                  tree["enc_layers"]["attn"]["wq"]["w"][1])
    np.testing.assert_array_equal(sd["layers.1.xattn.wk.w"].numpy(),
                                  tree["layers"]["xattn"]["wk"]["w"][1])
    with pytest.raises(ValueError, match="stacked enc_layers"):
        lm_params_from_jax(tree, dataclasses.replace(cfg, enc_layers=cfg.enc_layers + 1))
