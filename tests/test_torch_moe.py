"""The port's MoE family (``repro_torch.models.moe``, ``MoEBlock`` in
``models/lm.py``) against the JAX package's ``models/moe.py`` and
``models/lm.py``, with the JAX parameters (``init_moe``/``init_lm``
through the converters) and inputs made by numpy from a seed.

- Dispatch: on the same top-k expert ids (``torch.topk`` does not promise
  ``lax.top_k``'s tie order, so both sides get the same ids), the sorted
  expert ids, buffer positions, source tokens and drops equal JAX's
  exactly, at capacity factor 0.5 (tokens drop), 8.0 (none drop) and with
  ``moe_dispatch_chunks=2``.
- ``MoE`` against ``apply_moe`` (jitted) on moonshot's smoke config (no
  shared expert) and llama4-scout's (a shared expert), unquantized and on
  fake-quant with nearest rounding, and moonshot's with two dispatch
  chunks: the output within ``1e-5 max(1, max|ref|)`` (seen 1.6e-7; the
  router's and the experts' sums run in other orders) and the aux loss
  within ``1e-6`` relative (seen 1.2e-7).
- The batched expert fake-quant (``lowbit_matmul_stack``) equals a loop
  over experts of the port's ``lowbit_matmul`` bit for bit, forward and
  both gradients, under nearest rounding and on given rounding offsets.
- ``lm_loss`` and its gradients against JAX's on moonshot's smoke config
  (unquantized and fake-quant, key None): the loss and the aux within
  ``1e-6`` relative (seen 7.6e-8, 1.2e-7), each gradient within ``1e-4``
  relative in the L2 norm (seen 8.7e-7), as ``test_torch_lm_train.py``
  holds the other families; no fake-quant code moves to its neighbour in
  this step.
- ``quant_backend="pallas"``: moonshot's smoke model served on the port's
  K1/K3 (their plain versions here) against JAX's pallas model (interpret
  mode) within ``1e-3 max(1, max|ref|)`` (as ``test_torch_lm.py``; seen
  1.5e-7, no code flip), with
  the launches of ``chip_smoke.serve_linears``: attention only (the routed
  experts run the fake-quant GEMMs, as in JAX).
- ``convert.lm_params_from_jax`` of moonshot's and llama4-scout's smoke
  trees: every JAX leaf lands in the port's ``state_dict`` with its shape
  (expert stacks whole), none left over.
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
from repro.models import lm as jlm  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import cnn_params_from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.core import QuantConfig  # noqa: E402
from repro_torch.core.lowbit import lowbit_matmul, lowbit_matmul_stack  # noqa: E402
from repro_torch.kernels import launch, reset_launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.moe import MoE, dispatch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCHS = ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that the test workers sharing
    the machine do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(name, **over):
    return (dataclasses.replace(jconfigs.get_smoke_config(name), **over),
            dataclasses.replace(configs.get_smoke_config(name), **over))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_dispatch(topi, k, cap):
    """``_apply_moe_rows``'s dispatch, step by step, on given expert ids."""
    b = topi.shape[0]
    e_flat = topi.reshape(b, -1)
    order = jnp.argsort(e_flat, axis=1, stable=True)
    se = jnp.take_along_axis(e_flat, order, axis=1)
    pos = jax.vmap(jmoe._positions_in_runs)(se)
    return order, se, pos, order // k, pos >= cap


@pytest.mark.parametrize("capacity,chunks", [(0.5, 1), (8.0, 1), (1.0, 2)])
def test_dispatch_matches_jax(capacity, chunks):
    """The rows as ``apply_moe`` hands them to ``_apply_moe_rows``: with two
    chunks each row is two rows of half the length, with their own
    capacity."""
    b, s, e, k = 3, 16, 8, 2
    rng = np.random.default_rng(0)
    # each token's k distinct experts, skewed so that some experts overflow
    p = rng.dirichlet(np.full(e, 0.3))
    topi = np.stack([rng.choice(e, k, replace=False, p=p) for _ in range(b * s)])
    topi = topi.reshape(b * chunks, s // chunks, k).astype(np.int32)
    cap = int(s // chunks * k / e * capacity + 1)
    order, se, pos, tok, drop = (np.asarray(a) for a in jax.jit(
        _jax_dispatch, static_argnums=(1, 2))(jnp.asarray(topi), k, cap))
    got = dispatch(torch.from_numpy(topi).long(), cap)
    np.testing.assert_array_equal(got["order"].numpy(), order)
    np.testing.assert_array_equal(got["expert"].numpy(), se)
    np.testing.assert_array_equal(got["pos"].numpy(), pos)
    np.testing.assert_array_equal(got["token"].numpy(), tok)
    np.testing.assert_array_equal((~got["keep"]).numpy(), drop)
    assert drop.any() == (capacity < 8.0)  # the skew overflows all but the roomiest


MOE_CASES = [("moonshot-v1-16b-a3b", "off", 1), ("moonshot-v1-16b-a3b", "fake_quant", 1),
             ("llama4-scout-17b-a16e", "off", 1), ("llama4-scout-17b-a16e", "fake_quant", 1),
             ("moonshot-v1-16b-a3b", "fake_quant", 2)]


@pytest.mark.parametrize("name,backend,chunks", MOE_CASES)
def test_moe_matches_apply_moe(name, backend, chunks):
    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    jcfg, cfg = _cfgs(name, moe_dispatch_chunks=chunks, **over)
    params = jmoe.init_moe(jax.random.key(1), jcfg)
    moe = MoE(cfg)
    moe.load_state_dict(cnn_params_from_jax(jax.tree.map(np.asarray, params)))
    x = np.random.default_rng(2).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    jq = jcfg.qcfg()
    ref, ref_aux = jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg, jq, None))(
        params, jnp.asarray(x))
    with torch.no_grad():
        got, aux = moe(torch.from_numpy(x), cfg.qcfg(), None)
    ref = np.asarray(ref)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * max(1.0, np.abs(ref).max()))
    assert abs(float(aux) - float(ref_aux)) <= 1e-6 * abs(float(ref_aux))
    assert (moe.shared is not None) == (name == "llama4-scout-17b-a16e")


@pytest.mark.parametrize("given", [False, True], ids=["nearest", "given_offsets"])
@pytest.mark.parametrize("k", [64, 256])
def test_stacked_fake_quant_equals_the_loop_bit_for_bit(given, k):
    """K 256 spans two scaling groups of 128 (the GEMMs' sums are then not
    exact: the stacked and the single matmul add in the same order)."""
    cfg = QuantConfig(backend="fake_quant", stochastic=given)
    e, r_, n = 4, 9, 40
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((e, r_, k), generator=gen)
    w = torch.randn((e, k, n), generator=gen) * 0.05
    g = torch.randn((e, r_, n), generator=gen)
    r = tuple(torch.rand(shape, generator=gen) - 0.5
              for shape in ((e, r_, k), (e, k, n), (e, r_, n))) if given else None
    xs, ws = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = lowbit_matmul_stack(xs, ws, None, cfg, r)
    y.backward(g)
    for i in range(e):
        xi, wi = x[i].clone().requires_grad_(), w[i].clone().requires_grad_()
        yi = lowbit_matmul(xi, wi, None, cfg, None if r is None else tuple(t[i] for t in r))
        yi.backward(g[i])
        assert torch.equal(y[i].detach(), yi.detach()), i
        assert torch.equal(xs.grad[i], xi.grad) and torch.equal(ws.grad[i], wi.grad), i


def _jax_loss_and_grads(jcfg, params, batch):
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None), has_aux=True))
    (loss, metrics), grads = fn(params, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(metrics["aux"]), lm_params_from_jax(
        jax.tree.map(np.asarray, grads), jcfg)


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


@pytest.mark.parametrize("backend", ["off", "fake_quant"])
def test_lm_loss_and_grads_match_jax(backend):
    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", **over)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    batch = {"tokens": np.random.default_rng(4).integers(0, cfg.vocab, (2, 16)).astype(np.int32)}
    ref_loss, ref_aux, ref_grads = _jax_loss_and_grads(jcfg, params, batch)
    loss, metrics = lm.lm_loss(model, {"tokens": torch.from_numpy(batch["tokens"]).long()})
    loss.backward()
    assert abs(float(loss) - ref_loss) <= 1e-6 * abs(ref_loss)
    assert ref_aux > 0 and abs(float(metrics["aux"]) - ref_aux) <= 1e-6 * ref_aux
    grads = {k: p.grad for k, p in model.named_parameters()}
    assert set(grads) == set(ref_grads)
    worst = max((_rel(g, ref_grads[k]), k) for k, g in grads.items())
    assert worst[0] <= 1e-4, worst


def test_pallas_model_serves_like_jax_and_launches_attention_only():
    jcfg, cfg = _cfgs("moonshot-v1-16b-a3b", quant_backend="pallas")
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (2, 10)).astype(np.int32)
    jl, jc = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, 16))(
        params, {"tokens": jnp.asarray(toks[:, :8])})
    jdec = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
    reset_launch_counts()
    tl, tc = lm.prefill(model, {"tokens": torch.from_numpy(toks[:, :8]).long()}, 16)
    refs, gots = [np.asarray(jl)], [tl.numpy()]
    for i in (8, 9):
        jl, jc = jdec(params, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = lm.decode_step(model, tc, torch.from_numpy(toks[:, i:i + 1]).long())
        refs.append(np.asarray(jl))
        gots.append(tl.numpy())
    counts = {k: sum(c for (kernel, *_), c in launch.RECORDED.items() if kernel == k)
              for k in ("mls_quantize_rows", "mls_matmul")}  # the plain versions' records
    n = _chip_smoke().serve_linears(cfg)
    assert n == 4 * cfg.n_layers  # the attention's four linears per layer, no expert
    assert (counts["mls_quantize_rows"], counts["mls_matmul"]) == (2 * 3 * n, 3 * n)
    for r, g in zip(refs, gots):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * max(1.0, np.abs(r).max()))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_lm_params_from_jax_round_trip(name):
    jcfg, cfg = _cfgs(name)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    sd = lm_params_from_jax(tree, cfg)
    model = lm.LM(cfg)
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert sum(v.numel() for v in sd.values()) == sum(a.size for a in jax.tree.leaves(tree))
    model.load_state_dict(sd)  # strict: none left over, none missing
    stack = tree["layers"]["moe"]["w_up"]
    assert sd["layers.1.moe.w_up"].shape == stack.shape[1:]  # (E, d, f), whole
    np.testing.assert_array_equal(sd["layers.1.moe.w_up"].numpy(), stack[1])
