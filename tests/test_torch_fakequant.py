"""The port's whole-tensor MLS quantizer and its fake-quant training ops
(``repro_torch.core.quantize`` / ``core.lowbit``) against the JAX package.

Bit-exact: every field of ``mls_quantize`` (sign, scales and their stored
fields, the elements and theirs), ``fake_quant``, ``pack_elements`` /
``unpack_elements``, ``unit_value`` / ``frac_int``, for the four
groupings and <2,4>, <2,1>, <0,4>, with JAX's own ``srandom_like(key, x)``
passed to the port as its rounding offsets.  The inputs are normal data
whose group ratios stay far above 2^-12, where ``jnp.exp2`` is exact
(ROADMAP queue 3); the tests assert that.

``average_relative_error`` is a ratio of two fp32 means of n non-negative
terms, which torch and XLA sum in their own orders; any order is within
(n - 1) eps of the exact sum, so the ratio is held to 2 n eps relative
(n = 600: 7.2e-5; seen: up to 5e-7).

The fake-quant ops (``lowbit_matmul`` / ``lowbit_conv``) quantize
bit-exactly, then run fp32 matmuls / convs, which the two libraries also
sum in their own orders.  With nearest rounding the forward and both
gradients are held to ``1e-5 * max|ref|`` absolute (seen: below 2e-7
relative); the quantized operands themselves are compared bit for bit
through the ops' saved tensors.  A ResNet-20 training step on the
fake-quant backend is held to the limits of ``test_torch_resnet.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.core import lowbit as jlowbit  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.models.cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.cnn import apply_cnn, init_cnn as jinit_cnn  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core import EMFormat, GroupSpec, QuantConfig  # noqa: E402
from repro_torch.core import lowbit  # noqa: E402
from repro_torch.core import quantize as q  # noqa: E402
from repro_torch.models.cnn import CNNConfig, build_cnn  # noqa: E402

FORMATS = [(2, 4), (2, 1), (0, 4)]
GROUPINGS = ["nc", "c", "n", "none"]
FIELDS = ("sign", "s_t", "s_g", "exp_g", "man_g", "xbar", "exp_x", "man_x")

_jax_mls = jax.jit(jq.mls_quantize, static_argnums=(1, 2, 3))
_jax_srandom = jax.jit(jformats.srandom_like)


def _x(seed, shape=(4, 6, 5, 5)):
    """Normal data with per-(n, c) magnitudes spread over a decade."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.2, 3.0, shape[:2] + (1,) * (len(shape) - 2))
    return x.astype(np.float32)


def _specs(grouping):
    ours, ref = QuantConfig(grouping=grouping), JQuantConfig(grouping=grouping)
    (sa, _), (ja, _) = ours.conv_specs(), ref.conv_specs()
    assert sa.block == ja.block
    return sa, ja


def _both(x, fmt, grouping, stochastic, seed=0):
    """The port's and JAX's MLSTensor of ``x``; JAX's rounding offsets go to
    the port as ``r``."""
    spec, jspec = _specs(grouping)
    key = jax.random.key(seed) if stochastic else None
    r = torch.from_numpy(np.array(_jax_srandom(key, jnp.asarray(x)))) if stochastic else None
    ours = q.mls_quantize(torch.from_numpy(x), EMFormat(*fmt), spec, r=r)
    ref = _jax_mls(jnp.asarray(x), jformats.EMFormat(*fmt), jspec, jformats.GS_FMT_DEFAULT, key)
    return ours, ref


@pytest.mark.parametrize("stochastic", [False, True], ids=["nearest", "stochastic"])
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f"e{f[0]}m{f[1]}")
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_mls_quantize_fields_match_jax(grouping, fmt, stochastic):
    x = _x(1)
    ours, ref = _both(x, fmt, grouping, stochastic)
    assert float(ours.s_g.min() / ours.s_t) > 2.0**-12  # where jnp.exp2 is exact
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ours, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(ours.dequant().numpy(), np.asarray(ref.dequant()))
    np.testing.assert_array_equal(ours.unit_value().numpy(), np.asarray(ref.unit_value()))
    np.testing.assert_array_equal(ours.frac_int().numpy(), np.asarray(ref.frac_int()))
    assert ours.sign.dtype == torch.int8 and ours.exp_x.dtype == torch.int32


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f"e{f[0]}m{f[1]}")
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_fake_quant_and_codec_match_jax(grouping, fmt):
    x = _x(2)
    spec, jspec = _specs(grouping)
    key = jax.random.key(3)
    r = torch.from_numpy(np.array(_jax_srandom(key, jnp.asarray(x))))
    got = q.fake_quant(torch.from_numpy(x), EMFormat(*fmt), spec, r=r)
    want = jq.fake_quant(jnp.asarray(x), jformats.EMFormat(*fmt), jspec, key=key)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ours, ref = _both(x, fmt, grouping, True, seed=4)
    codes, jcodes = q.pack_elements(ours), jq.pack_elements(ref)
    assert codes.dtype == torch.uint8
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    sign, mag = q.unpack_elements(codes, EMFormat(*fmt))
    jsign, jmag = jq.unpack_elements(jcodes, jformats.EMFormat(*fmt))
    np.testing.assert_array_equal(sign.numpy(), np.asarray(jsign))
    np.testing.assert_array_equal(mag.numpy(), np.asarray(jmag))
    np.testing.assert_array_equal(mag.numpy(), ours.xbar.numpy())  # the codec is exact


def test_pack_refuses_wide_formats():
    t = q.mls_quantize(torch.ones(4), EMFormat(4, 4))
    with pytest.raises(ValueError, match="does not fit in 8 bits"):
        q.pack_elements(t)


@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f"e{f[0]}m{f[1]}")
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_average_relative_error_matches_jax(grouping, fmt):
    x = _x(5)
    spec, jspec = _specs(grouping)
    xq = q.fake_quant(torch.from_numpy(x), EMFormat(*fmt), spec)
    got = float(q.average_relative_error(torch.from_numpy(x), xq))
    want = float(jq.average_relative_error(jnp.asarray(x), jnp.asarray(xq.numpy())))
    assert abs(got - want) <= 2 * x.size * np.finfo(np.float32).eps * want
    assert float(q.average_relative_error(torch.zeros(3), torch.zeros(3))) == 0.0


def test_fake_quant_ste_passes_the_gradient_straight_through():
    x = torch.from_numpy(_x(6)).requires_grad_()
    y = q.fake_quant_ste(x, EMFormat(2, 1), GroupSpec.conv_nc())
    g = torch.from_numpy(_x(7))
    (y * g).sum().backward()
    assert torch.equal(x.grad, g)
    assert torch.equal(y.detach(), q.fake_quant(x.detach(), EMFormat(2, 1), GroupSpec.conv_nc()))


def test_rounding_source_is_explicit():
    """A generator draws the offsets; the same seed gives the same bits, no
    source rounds to nearest, and a wrong-shaped tensor is refused."""
    x = torch.from_numpy(_x(8))
    fmt, spec = EMFormat(2, 1), GroupSpec.conv_nc()
    a = q.fake_quant(x, fmt, spec, r=torch.Generator().manual_seed(1))
    b = q.fake_quant(x, fmt, spec, r=torch.Generator().manual_seed(1))
    c = q.fake_quant(x, fmt, spec, r=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(q.fake_quant(x, fmt, spec), q.fake_quant(x, fmt, spec, r=None))
    with pytest.raises(ValueError, match="do not match"):
        q.mls_quantize(x, fmt, spec, r=torch.zeros(3))


def test_quant_config_backends():
    assert QuantConfig().backend == "quantized"
    assert QuantConfig(backend="fake_quant").backend == "fake_quant"
    with pytest.raises(ValueError, match="backend"):
        QuantConfig(backend="pallas")


@pytest.mark.parametrize("grouping", GROUPINGS)
def test_matmul_and_conv_specs_match_jax(grouping):
    ours, ref = QuantConfig(grouping=grouping), JQuantConfig(grouping=grouping)
    for xs, ws in (((5, 7, 300), (300, 9)), ((12, 64), (64, 3))):
        for a, b in zip(ours.matmul_specs(xs, ws), ref.matmul_specs(xs, ws)):
            assert a.block == b.block
    for a, b in zip(ours.conv_specs(), ref.conv_specs()):
        assert a.block == b.block


# ---------------------------------------------------------------------------
# The fake-quant training ops
# ---------------------------------------------------------------------------
def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=atol, err_msg=what)


def _cfgs(fmt, grouping, k_block=32):
    return (QuantConfig(fmt=EMFormat(*fmt), grouping=grouping, k_block=k_block,
                        stochastic=False, backend="fake_quant"),
            JQuantConfig(fmt=jformats.EMFormat(*fmt), grouping=grouping, k_block=k_block,
                         stochastic=False))


@pytest.mark.parametrize("fmt", FORMATS[:2], ids=lambda f: f"e{f[0]}m{f[1]}")
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_lowbit_matmul_matches_jax(grouping, fmt):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((3, 5, 80)).astype(np.float32)
    w = (rng.standard_normal((80, 7)) * 0.3).astype(np.float32)
    g = rng.standard_normal((3, 5, 7)).astype(np.float32)
    ours, ref = _cfgs(fmt, grouping)

    def jloss(a, b):
        return jnp.sum(jlowbit.lowbit_matmul(a, b, None, ref) * g)

    y_ref = jax.jit(lambda a, b: jlowbit.lowbit_matmul(a, b, None, ref))(x, w)
    dx_ref, dw_ref = jax.jit(jax.grad(jloss, argnums=(0, 1)))(x, w)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = lowbit.lowbit_matmul(xt, wt, None, ours)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y, y_ref, "y")
    _close(xt.grad, dx_ref, "dx")
    _close(wt.grad, dw_ref, "dw")


CONV_CASES = [((2, 5, 9, 9), (7, 5, 3, 3), (1, 1), "SAME"),
              ((2, 4, 8, 8), (6, 4, 3, 3), (2, 2), "SAME"),
              ((2, 4, 10, 10), (6, 4, 1, 1), (2, 2), "VALID"),
              ((1, 6, 7, 7), (5, 6, 5, 5), (1, 1), "SAME")]


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case,fmt", [(c, (2, 4)) for c in CONV_CASES] + [(CONV_CASES[0], (2, 1))],
                         ids=["3x3", "3x3s2", "1x1s2_valid", "5x5", "3x3-e2m1"])
def test_lowbit_conv_matches_jax(case, fmt, grouping):
    xs, ws, stride, pad = case
    rng = np.random.default_rng(10)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.3).astype(np.float32)
    ours, ref = _cfgs(fmt, grouping)
    fwd = jax.jit(lambda a, b: jlowbit.lowbit_conv(a, b, None, stride, pad, ref))
    y_ref = fwd(x, w)
    g = rng.standard_normal(y_ref.shape).astype(np.float32)
    dx_ref, dw_ref = jax.jit(jax.grad(lambda a, b: jnp.sum(fwd(a, b) * g), argnums=(0, 1)))(x, w)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = lowbit.lowbit_conv(xt, wt, None, stride, pad, ours)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y, y_ref, "y")
    _close(xt.grad, dx_ref, "dx")
    _close(wt.grad, dw_ref, "dw")
    # the quantized operands themselves: bit-exact
    sa, sw = ours.conv_specs()
    qx, _ = lowbit.quantize_operand(torch.from_numpy(x), ours, sa, None, 0)
    jqx, _ = jlowbit.quantize_operand(jnp.asarray(x), ref, ref.conv_specs()[0], None, 0)
    np.testing.assert_array_equal(qx.numpy(), np.asarray(jqx))


def test_fake_quant_ops_quantize_the_error_once_on_streams_0_1_2(monkeypatch):
    """Forward: the two operands on rounding streams 0 and 1; backward: the
    error once (stream 2), reused by both gradients."""
    idxs = []
    orig = lowbit.quantize_operand

    def spy(x, cfg, spec, key, idx, r=None):
        idxs.append(idx)
        return orig(x, cfg, spec, key, idx, r)

    monkeypatch.setattr(lowbit, "quantize_operand", spy)
    cfg = QuantConfig(fmt=EMFormat(2, 4), backend="fake_quant", k_block=32)
    x = torch.randn(2, 4, 6, 6, requires_grad=True)
    w = torch.randn(5, 4, 3, 3, requires_grad=True)
    lowbit.lowbit_conv(x, w, 11, (1, 1), "SAME", cfg).sum().backward()
    assert idxs == [0, 1, 2]
    idxs.clear()
    a, b = torch.randn(3, 40, requires_grad=True), torch.randn(40, 6, requires_grad=True)
    lowbit.lowbit_matmul(a, b, 11, cfg).sum().backward()
    assert idxs == [0, 1, 2]
    # stochastic rounding is a function of the key: same key, same result
    y1 = lowbit.lowbit_conv(x, w, 11, (1, 1), "SAME", cfg)
    y2 = lowbit.lowbit_conv(x, w, 11, (1, 1), "SAME", cfg)
    y3 = lowbit.lowbit_conv(x, w, 12, (1, 1), "SAME", cfg)
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)


def test_resnet20_fake_quant_step_matches_jax():
    """A ResNet-20 training step on the fake-quant backend (the JAX
    package's default) at <2,1>, nearest rounding: loss within 1e-5 relative,
    logits within 1e-5, every gradient cosine >= 1 - 1e-6 and relative
    error <= 1e-4 (the limits of ``test_torch_resnet.py``)."""
    width, hw, fmt = 0.25, 8, (2, 1)
    jcfg = JCNNConfig("resnet20", width_mult=width, in_hw=hw)
    params = jax.tree.map(np.asarray, jax.jit(lambda k: jinit_cnn(k, jcfg))(jax.random.key(0)))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, hw, hw)).astype(np.float32)
    labels = np.array([3, 7])
    jq_cfg = JQuantConfig(fmt=jformats.EMFormat(*fmt), k_block=32, stochastic=False)

    def loss_fn(p):
        logits = apply_cnn(p, jnp.asarray(x), jcfg, jq_cfg, None)
        ll = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(ll, jnp.asarray(labels)[:, None], 1).mean(), logits

    (l_j, z_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    model = build_cnn(CNNConfig("resnet20", width_mult=width, in_hw=hw))
    model.load_state_dict(cnn_params_from_jax(params), strict=True)
    qcfg = QuantConfig(fmt=EMFormat(*fmt), k_block=32, stochastic=False, backend="fake_quant")
    logits = model(torch.from_numpy(x), qcfg, None)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    assert abs(loss.item() - float(l_j)) <= 1e-5 * abs(float(l_j))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(z_j), rtol=0, atol=1e-5)
    grads_j = cnn_params_from_jax(jax.tree.map(np.asarray, g_j))
    for name, p in model.named_parameters():
        a, b = p.grad.flatten().double(), grads_j[name].flatten().double()
        assert float(a @ b / (a.norm() * b.norm())) >= 1 - 1e-6, name
        assert float((a - b).norm() / b.norm()) <= 1e-4, name
