"""The port's ``ServeEngine`` (``repro_torch.serve``) and the serving path's
own consistency, on the CPU.

- Greedy generation equals the JAX package's ``ServeEngine.generate`` token
  for token (fp32 smoke configs of the dense, ssm and hybrid families,
  unquantized, the JAX parameters).
- Generation is deterministic (the quantized kernels' path, nearest
  rounding); temperature sampling repeats under one generator seed and
  varies across seeds, and without a generator raises.
- Decode matches the port's own teacher-forced forward, in the style of
  ``tests/test_decode_consistency.py`` (its bound, 5e-4, is kept; seen
  below 6e-7), the hybrid's ring buffer against windowed attention over
  the whole sequence included.
- A KV-cache write past the end raises, where the JAX package's
  ``dynamic_update_slice`` clamps its start and overwrites the last slots
  (shown here: a defect of the reference, ROADMAP §3).
- ``examples/torch_serve_lm.py`` serves on the CPU.
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
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _prompts(vocab, b=2, s=8, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


@pytest.mark.parametrize("name", ["chatglm3-6b", "mamba2-370m", "zamba2-7b"])
def test_greedy_generation_equals_jax(name):
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), quant=False)
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant=False)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    prompts = _prompts(cfg.vocab)
    ref = JServeEngine(jcfg, params, max_len=48).generate({"tokens": jnp.asarray(prompts)}, 6)
    got = ServeEngine(cfg, model, max_len=48, device="cpu").generate(
        {"tokens": torch.from_numpy(prompts)}, 6)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_generation_is_deterministic():
    cfg = dataclasses.replace(configs.get_smoke_config("chatglm3-6b"), quant_backend="pallas")
    eng = ServeEngine(cfg, lm.init_lm(cfg, 0, "cpu"), max_len=48, device="cpu")
    prompts = {"tokens": torch.from_numpy(_prompts(cfg.vocab))}
    out1 = eng.generate(prompts, 6)
    out2 = eng.generate(prompts, 6)
    assert out1.shape == (2, 6) and torch.equal(out1, out2)
    assert bool(((out1 >= 0) & (out1 < cfg.vocab)).all())


def test_sampling_repeats_under_one_seed_and_varies_across_seeds():
    cfg = configs.get_smoke_config("mamba2-370m")
    eng = ServeEngine(cfg, lm.init_lm(cfg, 0, "cpu"), max_len=48, device="cpu")
    prompts = {"tokens": torch.from_numpy(_prompts(cfg.vocab))}

    def sample(seed):
        return eng.generate(prompts, 6, temperature=1.0,
                            generator=torch.Generator().manual_seed(seed))

    a, b = sample(2), sample(3)
    assert a.shape == (2, 6)
    assert torch.equal(a, sample(2))
    assert not torch.equal(a, b)
    with pytest.raises(ValueError, match="Generator"):
        eng.generate(prompts, 6, temperature=1.0)


@pytest.mark.parametrize("name", ["qwen2-72b", "chatglm3-6b", "mamba2-370m", "zamba2-7b"])
def test_decode_matches_teacher_forced_forward(name):
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant=False)
    model = lm.init_lm(cfg, 0, "cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab, 2, 16, seed=3)).long()
    with torch.no_grad():
        ref = model({"tokens": toks})
    logits, cache = lm.prefill(model, {"tokens": toks[:, :8]}, max_len=32)
    errs = [float((logits - ref[:, 7]).abs().max())]
    for i in range(8, 16):
        logits, cache = lm.decode_step(model, cache, toks[:, i:i + 1])
        errs.append(float((logits - ref[:, i]).abs().max()))
    assert max(errs) < 5e-4, errs


def test_hybrid_ring_buffer_equals_windowed_attention():
    cfg = dataclasses.replace(configs.get_smoke_config("zamba2-7b"), quant=False, window=8)
    model = lm.init_lm(cfg, 0, "cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab, 1, 24, seed=3)).long()
    with torch.no_grad():
        ref = model({"tokens": toks}, window=cfg.window)
    cache = lm.init_cache(cfg, 1, max_len=cfg.window, device="cpu")
    assert cache["ak"].shape[2] == 8
    errs = []
    for i in range(24):
        logits, cache = lm.decode_step(model, cache, toks[:, i:i + 1])
        errs.append(float((logits - ref[:, i]).abs().max()))
    assert max(errs) < 5e-4, errs


@pytest.mark.parametrize("name", ["qwen2-72b", "zamba2-7b"])
def test_a_cache_overflow_raises(name):
    cfg = dataclasses.replace(configs.get_smoke_config(name), quant=False)
    model = lm.init_lm(cfg, 0, "cpu")
    toks = torch.from_numpy(_prompts(cfg.vocab, 2, 8)).long()
    _, cache = lm.prefill(model, {"tokens": toks}, max_len=8)
    with pytest.raises(ValueError, match="KV cache overflow"):
        lm.decode_step(model, cache, toks[:, :1])
    with pytest.raises(ValueError, match="KV cache overflow"):
        lm.prefill(model, {"tokens": toks}, max_len=7)


def test_jax_reference_clamps_a_write_past_the_cache():
    """The reference's defect the port refuses: with the cache full, JAX's
    ``dynamic_update_slice`` moves the write to the last slot and serves a
    token with its predecessor's key gone."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("qwen2-72b"), quant=False)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    toks = jnp.asarray(_prompts(jcfg.vocab, 2, 9))
    _, cache = jlm.prefill(params, {"tokens": toks[:, :8]}, jcfg, 8)
    before = np.asarray(cache["k"])
    _, after = jlm.decode_step(params, cache, toks[:, 8:9], jcfg)
    after = np.asarray(after["k"])
    assert int(cache["pos"]) == 8 == before.shape[2]
    np.testing.assert_array_equal(after[:, :, :7], before[:, :, :7])
    assert not np.array_equal(after[:, :, 7], before[:, :, 7])  # slot 7 overwritten


def test_example_serves_on_the_cpu(capsys):
    spec = importlib.util.spec_from_file_location("torch_serve_lm",
                                                  ROOT / "examples" / "torch_serve_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    seqs = example.main(["--device", "cpu", "--arch", "mamba2-370m", "--backend", "pallas",
                         "--batch", "2", "--prompt-len", "5", "--tokens", "3"])
    assert seqs.shape == (2, 3)
    assert "decode:" in capsys.readouterr().out
