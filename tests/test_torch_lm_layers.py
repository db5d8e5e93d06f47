"""The port's LM layers, configs and parameter conversion against the JAX
package's.

- ``rmsnorm``/``layernorm`` (fp32 and bf16 inputs), ``rope_angles`` with
  ``apply_rope`` (full and GLM's half rotary), ``gqa_attention`` (causal,
  window, ``kv_len``, ``q_chunk``, a row with no valid key), ``ssd_chunked``
  (with and without an initial state), ``_causal_conv`` (a zero state
  equals padding), and the Mamba2 block's prefill (a prime length: chunk
  1) and O(1) decode recurrence, each against the JAX function (jitted)
  on the same numpy inputs.  Tolerance: fp32 ops in another order, within
  ``1e-5 max(1, max|ref|)`` (bf16 outputs: one bf16 ulp of the value).
- Every field of the ten full and smoke configs equals the JAX one;
  ``qcfg()`` maps ``quant_backend`` "pallas" to the port's "quantized".
- ``lm_params_from_jax`` maps a JAX ``init_lm`` tree onto the port's
  ``state_dict`` one to one, for the dense, ssm and hybrid families.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import nn as jnn  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import torch_dtype  # noqa: E402
from repro_torch.convert import cnn_params_from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.models import lm, mamba2  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402

ATOL = 1e-5


def _close(got, ref, rel=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref, dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(1.0, float(np.abs(ref).max())))


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# norms and rotary embeddings
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms_match_jax(norm, dtype):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, 24).astype(np.float32)
    beta = rng.standard_normal(24).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    xt = _t(x).to(torch_dtype(dtype))
    if norm == "rmsnorm":
        ref = jax.jit(jnn.rmsnorm)({"gamma": jnp.asarray(gamma)}, xj)
        got = L.rmsnorm(xt, _t(gamma))
    else:
        ref = jax.jit(jnn.layernorm)({"gamma": jnp.asarray(gamma), "beta": jnp.asarray(beta)}, xj)
        got = L.layernorm(xt, _t(gamma), _t(beta))
    assert got.dtype == xt.dtype
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype == "float32":
        _close(got, ref)
    else:  # the same fp32 value rounded to bf16: at most one bf16 ulp apart
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("rotary_pct", [1.0, 0.5])
def test_rope_matches_jax(rotary_pct):
    rng = np.random.default_rng(1)
    b, s, h, d = 2, 6, 3, 16
    rd = int(d * rotary_pct)
    x = rng.standard_normal((b, s, h, d)).astype(np.float32)
    pos = (np.arange(s)[None, :] + np.array([[0], [37]])).astype(np.int32)

    def jref(x, pos):
        sin, cos = jnn.rope_angles(pos, d, 1e4, rd)
        return jnn.apply_rope(x, sin, cos, rd), sin

    ref, sin_ref = jax.jit(jref)(jnp.asarray(x), jnp.asarray(pos))
    sin, cos = L.rope_angles(_t(pos), d, 1e4, rd)
    _close(sin, sin_ref)
    got = L.apply_rope(_t(x), sin, cos, rd)
    _close(got, ref)
    if rd < d:  # half rotary: the second half passes through untouched
        assert torch.equal(got[..., rd:], _t(x)[..., rd:])


ATTN_CASES = {
    "causal": dict(causal=True),
    "window": dict(causal=True, window=3),
    "kv_len": dict(causal=True, q_offset=2, kv_len=7),
    "q_chunk": dict(causal=True, q_chunk=4),
    "no_valid_key": dict(causal=False, kv_len=0),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_gqa_attention_matches_jax(case):
    kw = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    b, sq, sk, hq, hkv, d = 2, 8, 10, 4, 2, 16
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, d)).astype(np.float32)
    ref = jax.jit(lambda q, k, v: jnn.gqa_attention(q, k, v, **kw))(q, k, v)
    got = L.gqa_attention(_t(q), _t(k), _t(v), **kw)
    _close(got, ref)
    if case == "no_valid_key":  # -1e30, not -inf: the row averages V, no NaN
        mean_v = np.repeat(v.mean(axis=1), hq // hkv, axis=1)  # (b, hq, d)
        _close(got, np.broadcast_to(mean_v[:, None], got.shape))
    if case == "q_chunk":
        _close(got, L.gqa_attention(_t(q), _t(k), _t(v), causal=True))


# ---------------------------------------------------------------------------
# Mamba2 / SSD
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_jax(with_state):
    rng = np.random.default_rng(3)
    b, s, h, p, g, n, chunk = 2, 12, 4, 8, 2, 6, 4
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    a = -rng.uniform(0.01, 0.5, (b, s, h)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32)
    st = rng.standard_normal((b, h, p, n)).astype(np.float32) if with_state else None
    y_ref, s_ref = jax.jit(jmamba.ssd_chunked, static_argnums=4)(x, a, bm, cm, chunk, st)
    y, fin = mamba2.ssd_chunked(_t(x), _t(a), _t(bm), _t(cm), chunk,
                                None if st is None else _t(st))
    _close(y, y_ref)
    _close(fin, s_ref)


def test_causal_conv_matches_jax_and_a_zero_state_equals_padding():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 6)).astype(np.float32)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    bias = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32)
    for state in (None, st, np.zeros_like(st)):
        y_ref, ns_ref = jax.jit(jmamba._causal_conv)(x, w, bias, state)
        y, ns = mamba2._causal_conv(_t(x), _t(w), _t(bias), None if state is None else _t(state))
        _close(y, y_ref)
        _close(ns, ns_ref)
    padded = mamba2._causal_conv(_t(x), _t(w), _t(bias))
    zero = mamba2._causal_conv(_t(x), _t(w), _t(bias), torch.zeros(2, 3, 6))
    assert torch.equal(padded[0], zero[0]) and torch.equal(padded[1], zero[1])


def _mamba_pair(seed=0):
    cfg = dataclasses.replace(jconfigs.get_smoke_config("mamba2-370m"), quant=False)
    p = jmamba.init_mamba2(jax.random.key(seed), cfg)
    pc = dataclasses.replace(configs.get_smoke_config("mamba2-370m"), quant=False)
    block = mamba2.Mamba2Block(pc)
    block.load_state_dict(cnn_params_from_jax(jax.tree.map(np.asarray, p)))
    return cfg, p, block


def test_mamba2_prefill_at_a_prime_length_and_the_decode_recurrence_match_jax():
    """A prime prompt longer than ``ssm_chunk`` runs chunk 1; then one
    token through the O(1) recurrence from the prefill's state."""
    cfg, p, block = _mamba_pair()
    s = 17
    assert cfg.ssm_chunk == 16 and mamba2.ssd_chunk(s, cfg.ssm_chunk) == 1
    assert mamba2.ssd_chunk(300, 256) == 150 and mamba2.ssd_chunk(12, 16) == 12
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s + 1, cfg.d_model)).astype(np.float32)
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    st0 = (np.zeros((2, cfg.ssm_conv - 1, conv_dim), np.float32),
           np.zeros((2, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state), np.float32))
    run = jax.jit(lambda p, x, st: jmamba.apply_mamba2(p, x, cfg, None, None, st))
    y_ref, st_ref = run(p, x[:, :s], st0)
    y, st = block(_t(x[:, :s]), None, None, tuple(map(_t, st0)))
    _close(y, y_ref)
    for a, r in zip(st, st_ref):
        _close(a, r)
    y1_ref, st1_ref = run(p, x[:, s:], st_ref)
    y1, st1 = block(_t(x[:, s:]), None, None, st)
    _close(y1, y1_ref)
    for a, r in zip(st1, st1_ref):
        _close(a, r)


# ---------------------------------------------------------------------------
# configs and parameter conversion
# ---------------------------------------------------------------------------
def _fields(cfg):
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        out[f.name] = (v.e, v.m) if f.name in ("fmt", "gs_fmt") else v
    return out


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_configs_equal_the_jax_ones(name):
    assert sorted(configs.ARCHS) == sorted(jconfigs.ARCHS)
    for get in ("get_config", "get_smoke_config"):
        ours, ref = getattr(configs, get)(name), getattr(jconfigs, get)(name)
        assert _fields(ours) == _fields(ref)
        assert (ours.hd, ours.d_inner, ours.ssm_heads, ours.n_params(),
                ours.n_active_params()) == (ref.hd, ref.d_inner, ref.ssm_heads,
                                            ref.n_params(), ref.n_active_params())
    cfg = configs.get_config(name)
    assert [s.name for s in configs.runnable_shapes(cfg)] == \
        [s.name for s in jconfigs.runnable_shapes(jconfigs.get_config(name))]
    for shape in configs.SHAPES.values():
        assert _fields(configs.shape_model_config(cfg, shape)) == _fields(
            jconfigs.shape_model_config(jconfigs.get_config(name), jconfigs.SHAPES[shape.name]))


def test_qcfg_maps_the_backends():
    cfg = configs.get_smoke_config("chatglm3-6b")
    assert cfg.qcfg().backend == "fake_quant"  # the JAX default
    q = dataclasses.replace(cfg, quant_backend="pallas").qcfg()
    ref = dataclasses.replace(jconfigs.get_smoke_config("chatglm3-6b"),
                              quant_backend="pallas").qcfg()
    assert q.backend == "quantized"
    assert ((q.fmt.e, q.fmt.m), (q.gs_fmt.e, q.gs_fmt.m), q.grouping, q.k_block, q.stochastic) \
        == ((ref.fmt.e, ref.fmt.m), (ref.gs_fmt.e, ref.gs_fmt.m), ref.grouping, ref.k_block,
            ref.stochastic)
    assert dataclasses.replace(cfg, quant=False).qcfg() is None
    with pytest.raises(ValueError, match="quant_backend"):
        dataclasses.replace(cfg, quant_backend="quantized").qcfg()
    assert torch_dtype("bfloat16") is torch.bfloat16
    with pytest.raises(ValueError):
        torch_dtype("int8")


@pytest.mark.parametrize("name", ["qwen2-72b", "mamba2-370m", "zamba2-7b", "pixtral-12b"])
def test_lm_params_from_jax_is_one_to_one(name):
    jcfg = jconfigs.get_smoke_config(name)
    tree = jax.tree.map(np.asarray, jlm.init_lm(jax.random.key(0), jcfg))
    cfg = configs.get_smoke_config(name)
    sd = lm_params_from_jax(tree, cfg)
    model = lm.LM(cfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n_leaves = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(v.numel() for v in sd.values()) == n_leaves
    model.load_state_dict(sd)  # strict
    layers = tree["layers"]
    if cfg.family == "dense":
        np.testing.assert_array_equal(sd["layers.1.attn.wq.w"], layers["attn"]["wq"]["w"][1])
    else:
        np.testing.assert_array_equal(sd["layers.1.in_proj.w"], layers["in_proj"]["w"][1])
    with pytest.raises(ValueError, match="stacked layers"):
        lm_params_from_jax(tree, dataclasses.replace(cfg, n_layers=cfg.n_layers + 1))


def test_unported_families_raise():
    """Every family is ported: all ten full configs build (on the meta
    device: no memory) with the JAX package's parameter count, and only a
    family the JAX package does not have raises."""
    for name, cfg in configs.ARCHS.items():
        with torch.device("meta"):
            model = lm.LM(cfg)
        assert sum(p.numel() for p in model.parameters()) == sum(
            a.size for a in jax.tree.leaves(jax.eval_shape(
                lambda k, c=jconfigs.get_config(name): jlm.init_lm(k, c),
                jax.random.key(0)))), name
    with pytest.raises(ValueError, match="unknown LM family"):
        lm.LM(dataclasses.replace(configs.get_smoke_config("qwen2-72b"), family="rwkv"))
