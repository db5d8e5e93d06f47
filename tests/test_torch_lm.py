"""The port's LM serving path (``repro_torch.models.lm``: prefill and decode
over the KV and SSM caches) against the JAX package's ``lm.prefill`` /
``lm.decode_step`` (jitted), with the JAX parameters
(``lm_params_from_jax``) and the same numpy prompts.

- fp32, unquantized: the smoke configs of qwen2-72b, chatglm3-6b (GLM's
  half rotary), mamba2-370m, zamba2-7b, zamba2-7b with ``window=8`` (the
  ring buffer wraps during decode) and pixtral-12b (with its frontend
  embeddings): the prefill's logits and 8 decode steps within ``1e-5
  max(1, max|ref|)`` (seen: 5.7e-7 on logits below 0.6; JAX's own
  decode-against-forward bound is 5e-4).
- qwen2-72b with ``compute_dtype="bfloat16"``: XLA's CPU compiler by
  default keeps fused bf16 elementwise results in fp32
  (``xla_allow_excess_precision``), so the default-compiled JAX model is
  held to 4 bf16 ulps of max|ref| only (seen 2.1e-3 of max|ref| 0.45).
  Compiled with that option off, JAX rounds each op to bf16 as the
  program says, and the port agrees with it within ``1e-5 max(1,
  max|ref|)`` (seen 6e-8); the same weights computing in fp32 miss that
  bound by far (seen 2e-3), so the test sees the compute dtype.
- Quantized (``quant_backend="pallas"``, nearest rounding): every
  quantized linear of a real prefill step and a real decode step, on the
  very inputs the port gave it, is bit-identical to the JAX package's
  ``matmul_qd_ref`` (each smoke GEMM contracts at most 128 = one scaling
  group, so no group sum is reordered), and the step launches K1 twice and
  K3 once per linear (their plain versions here).  The whole model's
  logits against JAX's pallas model within ``1e-3 max(1, max|ref|)``:
  looser, because one ulp of an fp32 norm or attention sum before a
  quantizer can move an element to the neighbouring code (seen: 2.1e-7,
  no flip, at these sizes).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.kernels import matmul_qd_ref  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.kernels import launch, reset_launch_counts  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402


def pair(name: str, **overrides):
    """(JAX config, JAX params, the port's model with the same weights)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(name), **overrides)
    cfg = dataclasses.replace(configs.get_smoke_config(name), **overrides)
    params = jlm.init_lm(jax.random.key(0), jcfg)
    model = lm.LM(cfg)
    model.load_state_dict(lm_params_from_jax(jax.tree.map(np.asarray, params), cfg))
    return jcfg, params, model


def batches(cfg, b: int, s: int, steps: int, seed: int = 1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + steps)).astype(np.int32)
    extra = {}
    if cfg.frontend != "none":
        extra["frontend_emb"] = rng.standard_normal(
            (b, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return toks, extra


def serve_both(jcfg, params, model, toks, extra, s: int, max_len: int,
               compiler_options: dict | None = None):
    """Logits of the prefill of ``toks[:, :s]`` and of a decode step for each
    later token, from both packages: two lists of numpy arrays.  JAX's two
    functions are compiled with ``compiler_options`` (XLA's) where given."""
    batch = {"tokens": jnp.asarray(toks[:, :s]), **{k: jnp.asarray(v) for k, v in extra.items()}}
    jpre = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, max_len))
    jdec = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
    if compiler_options:
        jpre = jpre.lower(params, batch).compile(compiler_options=compiler_options)
        cache = jax.eval_shape(lambda p, b: jlm.prefill(p, b, jcfg, max_len), params, batch)[1]
        jdec = jdec.lower(params, cache, jnp.asarray(toks[:, s:s + 1])).compile(
            compiler_options=compiler_options)
    jl, jc = jpre(params, batch)
    tl, tc = lm.prefill(model, {"tokens": torch.from_numpy(toks[:, :s]).long(),
                                **{k: torch.from_numpy(v) for k, v in extra.items()}}, max_len)
    ref, got = [np.asarray(jl)], [tl.float().numpy()]
    for i in range(s, toks.shape[1]):
        jl, jc = jdec(params, jc, jnp.asarray(toks[:, i:i + 1]))
        tl, tc = lm.decode_step(model, tc, torch.from_numpy(toks[:, i:i + 1]).long())
        ref.append(np.asarray(jl))
        got.append(tl.float().numpy())
    return ref, got


FP32_CASES = {
    "qwen2-72b": ("qwen2-72b", {}),
    "chatglm3-6b": ("chatglm3-6b", {}),
    "mamba2-370m": ("mamba2-370m", {}),
    "zamba2-7b": ("zamba2-7b", {}),
    "zamba2-7b-window8": ("zamba2-7b", {"window": 8}),
    "pixtral-12b-frontend": ("pixtral-12b", {}),
}


@pytest.mark.parametrize("case", sorted(FP32_CASES))
def test_prefill_and_decode_match_jax_in_fp32(case):
    name, kw = FP32_CASES[case]
    jcfg, params, model = pair(name, quant=False, **kw)
    s = 8 if kw.get("window") else 12  # the ring buffer holds the prompt
    toks, extra = batches(model.cfg, 2, s, 8)
    ref, got = serve_both(jcfg, params, model, toks, extra, s, max_len=32)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))


def test_prefill_and_decode_match_jax_in_bf16():
    jcfg, params, model = pair("qwen2-72b", quant=False, compute_dtype="bfloat16")
    toks, extra = batches(model.cfg, 2, 12, 8)
    ref, got = serve_both(jcfg, params, model, toks, extra, 12, max_len=32)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=4 * 2.0 ** -8 * np.abs(r).max())
    # every bf16 rounding the program states, as XLA makes it when it may not skip one
    exact = {"xla_allow_excess_precision": False}
    ref, got = serve_both(jcfg, params, model, toks, extra, 12, 32, compiler_options=exact)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * max(1.0, np.abs(r).max()))
    # control: the same weights computing in fp32 miss that bound
    cfg32 = dataclasses.replace(model.cfg, compute_dtype="float32")
    model32 = lm.LM(cfg32)
    model32.load_state_dict(model.state_dict())
    _, got32 = serve_both(jcfg, params, model32, toks, extra, 12, 32, compiler_options=exact)
    assert min(np.abs(g - r).max() / max(1.0, np.abs(r).max())
               for r, g in zip(ref, got32)) > 1e-4


def _serve_linears(cfg) -> int:
    """Quantized linears per serving step: ``chip_smoke.serve_linears``,
    the closed form the chip run holds its launches to."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.serve_linears(cfg)


@pytest.mark.parametrize("name", ["qwen2-72b", "mamba2-370m", "zamba2-7b"])
def test_quantized_linears_match_matmul_qd_ref(name, monkeypatch):
    jcfg, params, model = pair(name, quant_backend="pallas")
    records = []
    port_linear = L.lowbit_matmul_qd

    def recording(x, w, key, qcfg):
        y = port_linear(x, w, key, qcfg)
        records.append((x.detach().numpy().copy(), w.detach().numpy().copy(),
                        y.detach().numpy().copy(), key, qcfg))
        return y

    monkeypatch.setattr(L, "lowbit_matmul_qd", recording)
    s, steps = 12, 2
    toks, extra = batches(model.cfg, 2, s, steps)
    reset_launch_counts()
    ref, got = serve_both(jcfg, params, model, toks, extra, s, max_len=32)
    launched = {k: sum(c for (kernel, *_), c in launch.RECORDED.items() if kernel == k)
                for k in ("mls_quantize_rows", "mls_matmul")}
    n = _serve_linears(model.cfg)
    assert len(records) == n * (1 + steps)
    assert launched == {"mls_quantize_rows": 2 * n * (1 + steps), "mls_matmul": n * (1 + steps)}
    q = model.cfg.qcfg()
    jq = JQuantConfig(fmt=jformats.EMFormat(q.fmt.e, q.fmt.m),
                      gs_fmt=jformats.EMFormat(q.gs_fmt.e, q.gs_fmt.m), grouping=q.grouping,
                      k_block=q.k_block, stochastic=False, backend="pallas")
    oracle = jax.jit(lambda x, w: matmul_qd_ref(x, w, None, jq))
    for x, w, y, key, qcfg in records:
        assert key is None and not qcfg.stochastic and qcfg.backend == "quantized"
        assert w.shape[0] <= q.k_block  # one scaling group: bit-exact
        np.testing.assert_array_equal(y, np.asarray(oracle(x, w)))
    for r, g in zip(ref, got):  # the whole model against JAX's pallas model
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * max(1.0, np.abs(r).max()))
