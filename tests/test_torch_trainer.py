"""The port's LM optimizers, schedule, token stream, train step and
launcher (``repro_torch.optim``, ``data``, ``train.trainer``,
``launch``) against the JAX package, and their own properties.

- One AdamW and one sgdm update (fp32 moments, weight decay on every
  parameter), ``clip_by_global_norm`` and ``cosine_schedule`` against the
  JAX functions on the same numpy inputs: at most 1 ulp apart (the
  elementwise formulas round at the same places; ``pow``, ``cos`` and the
  sum of squares may differ by one rounding).  A clipped gradient is ``g *
  scale`` with the scale from that norm: 2 ulps.
- ``make_train_step`` against JAX's, three AdamW or sgdm steps of
  chatglm3-6b's smoke config in fp32 without quantization, with
  microbatch 0 and 2, on the JAX token stream: loss and grad norm within
  ``1e-5`` relative, lr within 1 ulp, and the final parameters within
  ``1e-3 lr`` absolute (seen: 1.3e-4 lr).  AdamW's update is about ``lr *
  sign(g)`` per element, so an element whose exact gradient is 0 moves by
  rounding noise: the key bias's non-rotary half is left out of AdamW's
  comparison (seen: 7.9e-3 lr there), and sgdm holds it.
- Properties of the port alone, on the quantized path (the plain versions
  of K1/K3) with stochastic rounding: remat on and off give the same bits;
  the same seed gives the same step and another seed another; a run
  resumed from a checkpoint of (params, opt, data) repeats the
  uninterrupted one bit for bit; microbatch 2 on one step launches K1/K3
  twice as often.  The token stream's rule on injected draws;
  ``choose_microbatch`` against JAX's on a stand-in mesh; ``python -m
  repro_torch.launch.train --smoke --device cpu`` and the example run and
  resume.
"""
import collections
import dataclasses
import importlib.util
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.data import make_lm_iterator as jax_lm_iterator  # noqa: E402
from repro.launch.specs import choose_microbatch as jax_choose_microbatch  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import make_prefill_step as jax_make_prefill_step  # noqa: E402
from repro.train import make_serve_step as jax_make_serve_step  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.configs.base import SHAPES, RunConfig  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.data import lm_batch, make_lm_iterator, markov_tokens  # noqa: E402
from repro_torch.kernels import launch, reset_launch_counts  # noqa: E402
from repro_torch.launch import choose_microbatch  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.train import (  # noqa: E402
    CheckpointManager,
    make_prefill_step,
    make_serve_step,
    make_train_step,
)

ROOT = Path(__file__).resolve().parents[1]
SHAPES_ = {"a": (3, 5), "b": (7,), "c": (4, 4, 2)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These models are tiny: one intra-op thread each, so that the test
    workers sharing the machine do not spin against each other (the
    setting is restored for the worker's next file)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0, positive=False):
    rng = np.random.default_rng(seed)
    out = {k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in SHAPES_.items()}
    return {k: np.abs(v) for k, v in out.items()} if positive else out


def _t(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


def _ulps(got, want, maxulp=1):
    for k in want:
        np.testing.assert_array_max_ulp(np.asarray(got[k]), np.asarray(want[k]), maxulp=maxulp)


@pytest.mark.parametrize("step", [0, 4])
def test_adamw_update_matches_jax(step):
    p, g, m, v = _tree(0), _tree(1, 0.1), _tree(2, 0.01), _tree(3, 1e-4, positive=True)
    lr = jopt.cosine_schedule(3e-3, 2, 10)(step)
    jp, js = jopt.adamw_update(g, jopt.OptState(jnp.int32(step), m, v), p, lr)
    params = _t(p)
    state = optim.adamw_update(_t(g), optim.OptState(step, _t(m), _t(v)), params,
                               optim.cosine_schedule(3e-3, 2, 10)(step))
    assert state.step == int(js.step) == step + 1
    _ulps({k: t.numpy() for k, t in params.items()}, jp)
    _ulps({k: t.numpy() for k, t in state.mu.items()}, js.mu)
    _ulps({k: t.numpy() for k, t in state.nu.items()}, js.nu)


def test_sgdm_update_matches_jax():
    p, g, m = _tree(0), _tree(1, 0.1), _tree(2, 0.01)
    jp, js = jopt.sgdm_update(g, jopt.OptState(jnp.int32(3), m, ()), p, 0.05)
    params = _t(p)
    state = optim.sgdm_update(_t(g), optim.OptState(3, _t(m), {}), params, 0.05)
    assert state.step == 4 and state.nu == {}
    _ulps({k: t.numpy() for k, t in params.items()}, jp)
    _ulps({k: t.numpy() for k, t in state.mu.items()}, js.mu)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_jax(max_norm):
    g = _tree(5)
    jg, jn = jopt.clip_by_global_norm(g, max_norm)
    got, gn = optim.clip_by_global_norm(_t(g), max_norm)
    np.testing.assert_array_max_ulp(gn.numpy(), np.asarray(jn), maxulp=1)
    # the scale follows the norm within its ulp; each clipped gradient is
    # g * scale, one more rounding: 2 ulps of JAX's
    scale = np.minimum(np.float32(1), np.float32(max_norm) / gn.numpy())
    for k in g:
        np.testing.assert_array_equal(got[k].numpy(), g[k] * scale)
    _ulps({k: t.numpy() for k, t in got.items()}, jg, maxulp=2 if max_norm < float(gn) else 0)
    if max_norm > float(gn):  # below the limit: scale 1, the gradients unchanged
        for k in g:
            np.testing.assert_array_equal(got[k].numpy(), g[k])


def test_cosine_schedule_matches_jax():
    jfn, fn = jopt.cosine_schedule(3e-4, 100, 10_000), optim.cosine_schedule(3e-4, 100, 10_000)
    steps = [0, 1, 2, 50, 99, 100, 101, 2500, 5000, 9999, 10_000, 12_000]
    got = np.array([float(fn(s)) for s in steps], np.float32)
    want = np.array([float(jfn(s)) for s in steps], np.float32)
    assert got[0] == 0.0  # warmup from 0: the first step moves nothing
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_make_optimizer_names():
    for name in ("sgdm", "adamw"):
        init, _ = optim.make_optimizer(name)
        state = init({"w": torch.ones(3)})
        assert state.step == 0 and set(state.mu) == {"w"}
    with pytest.raises(ValueError, match="lion"):
        optim.make_optimizer("lion")


# ---------------------------------------------------------------------------
# the train step against JAX's
# ---------------------------------------------------------------------------
def _jax_batches(cfg, n, b=4, s=16):
    nxt, state = jax_lm_iterator(b, s, cfg.vocab, seed=0)
    out = []
    for _ in range(n):
        batch, state = nxt(state)
        out.append({k: np.asarray(v) for k, v in batch.items()})
    return out


def _comparable(name: str, p: np.ndarray, cfg, optimizer: str) -> np.ndarray:
    """The elements of parameter ``name`` that AdamW moves by their
    gradient: all but the key bias's non-rotary half, whose exact gradient
    is 0 (it adds the same ``q . b`` to every score of a query row, which
    the softmax ignores), so AdamW's ``m / sqrt(v)`` turns rounding noise
    into steps of about ``lr`` there, in either framework."""
    if optimizer == "adamw" and name.endswith("attn.wk.b"):
        rd = int(cfg.hd * cfg.rotary_pct)
        return p.reshape(cfg.n_kv_heads, cfg.hd)[:, :rd]
    return p


@pytest.mark.parametrize("optimizer", ["adamw", "sgdm"])
@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_matches_jax(microbatch, optimizer):
    over = dict(quant=False)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("chatglm3-6b"), **over)
    cfg = dataclasses.replace(configs.get_smoke_config("chatglm3-6b"), **over)
    lr = 1e-2
    jrun = jconfigs.RunConfig(model=jcfg, shape=jconfigs.SHAPES["train_4k"],
                              microbatch=microbatch, lr=lr, optimizer=optimizer)
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], microbatch=microbatch, lr=lr,
                    optimizer=optimizer)
    jstep, jinit = jax_make_train_step(jrun, jopt.cosine_schedule(lr, 1, 10))
    step, init = make_train_step(run, optim.cosine_schedule(lr, 1, 10))
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    jstate, state = jinit(params), init(model)
    jstep = jax.jit(jstep)
    for batch in _jax_batches(cfg, 3):
        params, jstate, jm = jstep(params, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        model, state, m = step(model, state, {k: torch.from_numpy(v) for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            assert abs(float(m[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
        np.testing.assert_array_max_ulp(m["lr"].numpy(), np.asarray(jm["lr"]), maxulp=1)
    assert state.step == int(jstate.step) == 3
    want = lm_params_from_jax(jax.tree.map(np.asarray, params), cfg)
    for k, p in model.named_parameters():
        np.testing.assert_allclose(_comparable(k, p.detach().numpy(), cfg, optimizer),
                                   _comparable(k, want[k].numpy(), cfg, optimizer),
                                   rtol=0, atol=1e-3 * lr, err_msg=k)


# ---------------------------------------------------------------------------
# properties of the port
# ---------------------------------------------------------------------------
def _run_steps(cfg, n, seed=0, microbatch=0, mgr=None, save_at=None):
    """``n`` AdamW steps of a fresh model from ``cfg`` on the port's token
    stream: (model, opt state, data iterator, losses)."""
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], microbatch=microbatch, lr=1e-2,
                    seed=seed)
    step, init = make_train_step(run, optim.cosine_schedule(run.lr, 1, 10))
    model = lm.init_lm(cfg, seed=0, device="cpu")
    opt, data, losses = init(model), make_lm_iterator(4, 16, cfg.vocab, device="cpu"), []
    for i in range(n):
        model, opt, m = step(model, opt, next(data))
        losses.append(m["loss"])
        if mgr is not None and i + 1 == save_at:
            mgr.save(i + 1, {"params": model.state_dict(), "opt": opt,
                             "data": data.state_dict()})
    return model, opt, data, losses, step


def _quantized(name="zamba2-7b", **kw):
    return dataclasses.replace(configs.get_smoke_config(name), quant_backend="pallas", **kw)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                  b.state_dict().values()))


def test_remat_gives_the_same_train_steps():
    runs = {r: _run_steps(_quantized(remat=r), 2) for r in ("none", "full")}
    assert [float(v) for v in runs["none"][3]] == [float(v) for v in runs["full"][3]]
    assert _same(runs["none"][0], runs["full"][0])
    for k, v in runs["none"][1].nu.items():
        assert torch.equal(runs["full"][1].nu[k], v)


def test_the_seed_keys_the_step():
    a, b, c = (_run_steps(_quantized("chatglm3-6b"), 2, seed=s)[:4] for s in (0, 0, 1))
    assert _same(a[0], b[0]) and [float(x) for x in a[3]] == [float(x) for x in b[3]]
    # another seed rounds other codes: the second step's loss and the weights differ
    assert float(a[3][1]) != float(c[3][1]) and not _same(a[0], c[0])


def test_a_resumed_run_repeats_the_uninterrupted_one(tmp_path):
    cfg = _quantized("mamba2-370m")
    mgr = CheckpointManager(tmp_path)
    full = _run_steps(cfg, 3, mgr=mgr, save_at=2)
    model, opt, data, _, step = _run_steps(cfg, 0)  # a fresh run, restored
    r = mgr.restore({"params": model.state_dict(), "opt": opt, "data": data.state_dict()})
    model.load_state_dict(r["params"])
    data.load_state_dict(r["data"])
    assert isinstance(r["opt"], optim.OptState) and r["opt"].step == 2 and data.step == 2
    model, opt, m = step(model, r["opt"], next(data))
    assert float(m["loss"]) == float(full[3][2]) and opt.step == 3
    assert _same(model, full[0])


def test_microbatches_split_the_batch_and_launch_per_part():
    cfg = _quantized("chatglm3-6b")
    for n in (0, 2):
        reset_launch_counts()
        _, _, _, losses, _ = _run_steps(cfg, 1, microbatch=n)
        counts = collections.Counter()
        for (kernel, *_), c in launch.RECORDED.items():  # the plain versions' records
            counts[kernel] += c
        assert torch.isfinite(losses[0])
        mod = _chip_smoke().lm_train_launches(cfg, microbatch=max(n, 1))
        assert {k: counts[k] for k in mod} == mod, n
    with pytest.raises(ValueError, match="microbatch 3"):
        _run_steps(cfg, 1, microbatch=3)


def test_the_token_stream_follows_its_rule_on_injected_draws():
    rng = np.random.default_rng(0)
    start, steps = rng.integers(0, 512, 3), rng.integers(0, 4, (3, 20))
    toks = markov_tokens(torch.from_numpy(start), torch.from_numpy(steps), 512).numpy()
    want = np.empty((3, 21), np.int64)
    want[:, 0] = start
    for t in range(20):
        want[:, t + 1] = (want[:, t] * 31 + steps[:, t] + 7) % 512
    np.testing.assert_array_equal(toks, want)
    # a drawn batch keeps the rule: its branch draws lie in [0, 4)
    b = lm_batch(torch.Generator().manual_seed(3), 2, 64, 65024, device="cpu")["tokens"]
    r = (b[:, 1:] - b[:, :-1] * 31 - 7) % 65024
    assert b.dtype == torch.int64 and bool(((r >= 0) & (r < 4)).all())
    # the iterator resumes from its state, with the frontend's embeddings
    it = make_lm_iterator(2, 8, 512, seed=5, extras=(("frontend_emb", (2, 4, 32)),),
                          device="cpu")
    first = [next(it) for _ in range(3)]
    again = make_lm_iterator(2, 8, 512, device="cpu", extras=(("frontend_emb", (2, 4, 32)),))
    again.load_state_dict({"step": 1, "seed": 5})
    nxt = next(again)
    assert all(torch.equal(nxt[k], first[1][k]) for k in ("tokens", "frontend_emb"))
    assert not torch.equal(first[0]["tokens"], first[1]["tokens"])


def test_the_token_stream_scan_equals_the_stepwise_rule():
    """markov_tokens composes the affine steps by a log-depth scan: at a
    full config's vocab and train_4k's length it gives the stepwise rule's
    tokens exactly."""
    rng = np.random.default_rng(1)
    vocab, seq = 152064, 4096
    start, steps = rng.integers(0, vocab, 2), rng.integers(0, 4, (2, seq - 1))
    want = np.empty((2, seq), np.int64)
    want[:, 0] = start
    for t in range(seq - 1):
        want[:, t + 1] = (want[:, t] * 31 + steps[:, t] + 7) % vocab
    got = markov_tokens(torch.from_numpy(start), torch.from_numpy(steps), vocab)
    np.testing.assert_array_equal(got.numpy(), want)
    one = markov_tokens(torch.tensor([5]), torch.zeros((1, 0), dtype=torch.int64), vocab)
    assert one.tolist() == [[5]]


@pytest.mark.parametrize("name", ["chatglm3-6b", "mamba2-370m"])
def test_serve_and_prefill_steps_match_jax(name):
    """make_prefill_step and make_serve_step against the JAX package's on
    an fp32 smoke config (unquantized, the JAX parameters): the prefill's
    and four decode steps' logits, to 1e-5 of their largest magnitude as
    tests/test_torch_lm.py holds the model's own prefill and decode."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), quant=False)
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant=False)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    toks = np.random.default_rng(2).integers(0, cfg.vocab, (2, 12)).astype(np.int32)
    jprefill = jax.jit(jax_make_prefill_step(jcfg, 32))
    jserve = jax.jit(jax_make_serve_step(jcfg))
    prefill, serve = make_prefill_step(cfg, 32), make_serve_step(cfg)
    ref, cache = jprefill(params, {"tokens": jnp.asarray(toks[:, :8])})
    refs = [ref]
    for i in range(8, 12):
        ref, cache = jserve(params, cache, jnp.asarray(toks[:, i:i + 1]))
        refs.append(ref)
    with torch.no_grad():
        got, tcache = prefill(model, {"tokens": torch.from_numpy(toks[:, :8]).long()})
        gots = [got]
        for i in range(8, 12):
            got, tcache = serve(model, tcache, torch.from_numpy(toks[:, i:i + 1]).long())
            gots.append(got)
    for r, g in zip(refs, gots):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))
    other = lm.LM(dataclasses.replace(cfg, n_layers=cfg.n_layers + 1))
    with pytest.raises(ValueError, match="built for"):
        prefill(other, {"tokens": torch.from_numpy(toks[:, :8]).long()})
    with pytest.raises(ValueError, match="built for"):
        serve(other, tcache, torch.from_numpy(toks[:, 8:9]).long())


@pytest.mark.parametrize("name", ["chatglm3-6b", "qwen2-72b", "mamba2-370m", "zamba2-7b",
                                  "seamless-m4t-medium"])
@pytest.mark.parametrize("dp", [1, 8, 64])
def test_choose_microbatch_matches_jax(name, dp):
    mesh = types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty((dp, 1)))
    for shape in ("train_4k", "decode_32k"):
        want = jax_choose_microbatch(jconfigs.get_config(name), jconfigs.SHAPES[shape], mesh)
        assert choose_microbatch(configs.get_config(name), SHAPES[shape], dp=dp) == want


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_launcher_trains_and_resumes_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch import train

    argv = ["--arch", "chatglm3-6b", "--smoke", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    first = train.main(argv + ["--steps", "3"])
    assert first["start"] == 0 and len(first["losses"]) == 3
    assert all(np.isfinite(first["losses"]))
    resumed = train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 1: loss=" in out
    assert resumed["start"] == 2 and resumed["losses"] == first["losses"][2:]


def test_example_trains_and_restores_on_the_cpu():
    spec = importlib.util.spec_from_file_location(
        "torch_train_lm_lowbit", ROOT / "examples" / "torch_train_lm_lowbit.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu", "--steps", "26", "--layers", "2", "--d-model", "64",
                        "--batch", "4", "--seq", "16"])
    assert len(out["losses"]) == 26 and all(np.isfinite(out["losses"]))
    # restored from the checkpoint of step 25, the next step is step 26 again
    assert out["restored_loss"] == out["losses"][25]
