"""The port's CNN zoo (``repro_torch.models.cnn``: ResNet-18/34, VGG-16,
GoogleNet), its op counter and the energy model against the JAX package.

- ``count_ops``, ``network_energy`` and ``efficiency_ratios`` at full
  width, for all five architectures: equal (integers, and the same fp64
  arithmetic in the same order).
- The converter maps each JAX pytree onto the port's parameters one to
  one, and the site tags of the quantized convs are the JAX package's.
- A training step of each model in fp32 against ``apply_cnn``, with the
  JAX parameters (``cnn_params_from_jax``): loss within 1e-5 relative,
  logits within ``1e-4 * max(1, max|z|)``, and for every parameter a
  gradient cosine >= 1 - 1e-4 and a relative error <= 2e-3 (1 - 1e-3 and
  2e-2 for GoogleNet).  BN's ``E[x^2] - mu^2`` loses digits to cancellation where a
  channel's mean dwarfs its spread, and the two frameworks sum BN, the
  convs and the classifier in their own orders; deep nets at these tiny
  widths amplify that (seen: logits within 2.9e-5 of max|z| 2.6 on VGG;
  gradient errors below 1.1e-4 on the ResNets and VGG, 2.2e-3 and a
  cosine of 1 - 1.0e-4 on GoogleNet).  Sizes: width 1/16 (GoogleNet 1/8), batch 2, 32x32 (64x64 for
  the ImageNet-stem ResNets, whose last stage would otherwise be 1x1, so
  that BN normalizes two values).
- The quantized convs of one step of each model, on both low-bit
  backends, held one by one to the JAX ops on the very inputs, weights
  and output gradients the step gave them: ``lowbit_conv_fused`` against
  ``lowbit_conv_fused_ref`` / ``conv_fused_grads_ref``, bit for bit where
  a GEMM has one scaling group; with G > 1 groups to ``(G - 1) eps
  max|ref|``, since the jnp oracle adds its group terms with ``jnp.sum``
  in XLA's order while the Pallas kernel (and the port) add them in k
  order (a weight gradient at batch 2, 32x32 sums 64 groups); and the 5x5
  convs' input gradient to a further ``25 eps max|dx|``: XLA's CPU backend
  adds a 5x5 window's taps in an order of its own choosing, which another
  backend would choose otherwise.  The reference's ``jnp.exp2`` is made
  exact for this test (ROADMAP queue 3: a real step's all-zero groups, at
  the padded border, take the scale 2^-120).  The fake-quant ``lowbit_conv``
  against the JAX ``lowbit_conv`` to ``1e-5 max|ref|`` (fp32 convs on the
  bit-exact quantized operands).  A whole quantized network is not
  compared end to end: an fp32 difference of one ulp before a quantizer
  can move an element to the neighbouring code, and at these sizes such
  flips compound through depth (seen: up to 1e-1 on GoogleNet's logits).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.models.cnn as jcnn  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.core import lowbit as jlowbit  # noqa: E402
from repro.core import quantize as jq  # noqa: E402
from repro.energy import model as jenergy  # noqa: E402
from repro.kernels import conv_fused_grads_ref, lowbit_conv_fused_ref  # noqa: E402
from repro_torch import energy  # noqa: E402
from repro_torch.convert import cnn_params_from_jax  # noqa: E402
from repro_torch.core import EMFormat, QuantConfig  # noqa: E402
from repro_torch.core.lowbit import lowbit_conv  # noqa: E402
from repro_torch.kernels import lowbit_conv_fused  # noqa: E402
from repro_torch.models import cnn  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402

ZOO = ["resnet18", "resnet34", "vgg16", "googlenet"]
ALL = ["resnet20"] + ZOO
# (width, in_hw) of the cross-tests, batch 2
SIZES = {"resnet18": (0.0625, 64), "resnet34": (0.0625, 64), "vgg16": (0.0625, 32),
         "googlenet": (0.125, 32)}
BATCH = 2


def _full(arch):
    return (dict(arch=arch, num_classes=10, in_hw=32) if arch == "resnet20"
            else dict(arch=arch, num_classes=1000, in_hw=224))


@pytest.mark.parametrize("arch", ALL)
def test_count_ops_matches_jax(arch):
    ours = cnn.count_ops(cnn.CNNConfig(**_full(arch)), batch=2)
    ref = jcnn.count_ops(jcnn.CNNConfig(**_full(arch)), batch=2)
    assert ours == [(k, {n: (bool(v) if isinstance(v, bool) else int(v)) for n, v in d.items()})
                    for k, d in ref]
    # the quantized flag is the JAX package's too (count_ops runs unquantized)
    assert not any(d.get("quantized") for _, d in ours)


@pytest.mark.parametrize("arch", ALL)
def test_energy_model_matches_jax(arch):
    ours, ref = cnn.CNNConfig(**_full(arch)), jcnn.CNNConfig(**_full(arch))
    for fw in ("fp32", "fp8", "int8", "mls"):
        assert energy.network_energy(ours, fw) == jenergy.network_energy(ref, fw)
    assert energy.efficiency_ratios(ours) == jenergy.efficiency_ratios(ref)
    for k in (1, 3, 5, 7):
        assert energy.conv_energy_ratio(k) == jenergy.conv_energy_ratio(k)
    assert energy.MAC_ENERGY_PJ == jenergy.MAC_ENERGY_PJ


def test_energy_headline():
    """The paper's 8.3-10.2x (vs fp32) holds for the ResNets and VGG-16."""
    for arch in ("resnet18", "resnet34", "vgg16"):
        r = energy.efficiency_ratios(cnn.CNNConfig(**_full(arch)))
        assert 8.3 <= r["vs_fp32"] <= 10.6, (arch, r)


@pytest.fixture(scope="module")
def jax_params():
    out = {}
    for arch in ZOO:
        width, hw = SIZES[arch]
        cfg = jcnn.CNNConfig(arch, width_mult=width, in_hw=hw)
        out[arch] = jax.tree.map(np.asarray,
                                 jax.jit(lambda k, c=cfg: jcnn.init_cnn(k, c))(jax.random.key(0)))
    return out


def _model(arch, params):
    width, hw = SIZES[arch]
    model = cnn.build_cnn(cnn.CNNConfig(arch, width_mult=width, in_hw=hw))
    model.load_state_dict(cnn_params_from_jax(params), strict=True)
    return model


def _batch(arch):
    hw = SIZES[arch][1]
    rng = np.random.default_rng(0)
    return rng.standard_normal((BATCH, 3, hw, hw)).astype(np.float32), np.array([3, 7])


@pytest.mark.parametrize("arch", ZOO)
def test_converter_covers_the_jax_tree_one_to_one(arch, jax_params):
    sd = cnn_params_from_jax(jax_params[arch])
    flat = jax.tree_util.tree_flatten_with_path(jax_params[arch])[0]
    assert len(sd) == len(flat)
    for path, leaf in flat:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        assert tuple(sd[name].shape) == leaf.shape, name
    model = _model(arch, jax_params[arch])
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(t.shape) for n, t in sd.items()}


@pytest.mark.parametrize("arch", ALL)
def test_site_tags_and_conv_geometry_follow_jax(arch, monkeypatch):
    """Every conv in call order: the same weight shape, stride, quantized
    or not, and (where quantized) stochastic-rounding site tag as the JAX
    package's."""
    width, hw = SIZES.get(arch, (0.25, 32))
    seen = {"ours": [], "ref": []}
    orig, orig_ref = L.conv2d, jcnn.nn.conv2d

    def note(who, shape, stride, qcfg, key):
        s = (stride, stride) if isinstance(stride, int) else tuple(stride)
        seen[who].append((tuple(shape), s, qcfg is not None, key if qcfg is not None else None))

    def ours_conv(x, w, stride=1, padding="SAME", qcfg=None, key=None):
        note("ours", w.shape, stride, qcfg, key)
        return orig(x, w, stride, padding, None, None)

    def ref_conv(p, x, stride=1, padding="SAME", qcfg=None, key=None):
        note("ref", p["w"].shape, stride, qcfg, key)
        return orig_ref(p, x, stride, padding, None, None)

    monkeypatch.setattr(cnn, "fold_in", lambda key, tag: tag)
    monkeypatch.setattr(jcnn, "_fold", lambda key, tag: tag)
    monkeypatch.setattr(L, "conv2d", ours_conv)
    monkeypatch.setattr(jcnn.nn, "conv2d", ref_conv)
    cfg = dict(arch=arch, width_mult=width, in_hw=hw)
    jcfg = jcnn.CNNConfig(**cfg)
    params = jax.eval_shape(lambda k: jcnn.init_cnn(k, jcfg), jax.random.key(0))
    jax.eval_shape(lambda p, x: jcnn.apply_cnn(p, x, jcfg, JQuantConfig(), 0), params,
                   jax.ShapeDtypeStruct((1, 3, hw, hw), jnp.float32))
    with torch.device("meta"):
        model = cnn.build_cnn(cnn.CNNConfig(**cfg))
        model(torch.empty((1, 3, hw, hw)), QuantConfig(), 0)
    assert seen["ours"] == seen["ref"]
    quantized = [q for _, _, q, _ in seen["ours"]]
    assert not quantized[0] and all(quantized[1:])  # the first conv unquantized


@pytest.mark.parametrize("arch", ZOO)
def test_fp32_step_matches_jax(arch, jax_params):
    x, labels = _batch(arch)
    width, hw = SIZES[arch]
    jcfg = jcnn.CNNConfig(arch, width_mult=width, in_hw=hw)

    def loss_fn(p):
        logits = jcnn.apply_cnn(p, jnp.asarray(x), jcfg, None, None)
        ll = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(ll, jnp.asarray(labels)[:, None], 1).mean(), logits

    (l_j, z_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jax_params[arch]))
    model = _model(arch, jax_params[arch])
    logits = model(torch.from_numpy(x), None, None)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()
    z_j = np.asarray(z_j)
    assert abs(loss.item() - float(l_j)) <= 1e-5 * abs(float(l_j))
    np.testing.assert_allclose(logits.detach().numpy(), z_j, rtol=0,
                               atol=1e-4 * max(1.0, float(np.abs(z_j).max())))
    limit, cos = (2e-2, 1e-3) if arch == "googlenet" else (2e-3, 1e-4)
    grads_j = cnn_params_from_jax(jax.tree.map(np.asarray, g_j))
    for name, p in model.named_parameters():
        a, b = p.grad.flatten().double(), grads_j[name].flatten().double()
        assert float(a @ b / (a.norm() * b.norm())) >= 1 - cos, name
        assert float((a - b).norm() / b.norm()) <= limit, name


def _captured_convs(arch, params, qcfg):
    """(x, w, stride, g) of every quantized conv of one training step of the
    port's model on ``qcfg``'s backend, in call order."""
    records = []
    impl = lowbit_conv_fused if qcfg.backend == "quantized" else lowbit_conv

    def record(x, w, key, stride, padding, cfg):
        y = impl(x, w, key, stride, padding, cfg)
        rec = {"x": x.detach().clone(), "w": w.detach().clone(), "stride": stride}
        y.register_hook(lambda g: rec.__setitem__("g", g.detach().clone()))
        records.append(rec)
        return y

    mp = pytest.MonkeyPatch()
    mp.setattr(L, "lowbit_conv_fused" if qcfg.backend == "quantized" else "lowbit_conv", record)
    try:
        x, labels = _batch(arch)
        model = _model(arch, params)
        logits = model(torch.from_numpy(x), qcfg, None)
        torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    finally:
        mp.undo()
    return records


def _port_op(rec, qcfg):
    xt, wt = rec["x"].clone().requires_grad_(), rec["w"].clone().requires_grad_()
    impl = lowbit_conv_fused if qcfg.backend == "quantized" else lowbit_conv
    y = impl(xt, wt, None, rec["stride"], "SAME", qcfg)
    y.backward(rec["g"])
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


class _ExactExp2:
    """``jax.numpy`` with an exact ``exp2`` of integer exponents in
    [-126, 127] (built from the exponent bits, as the port's ``pow2``):
    XLA's CPU ``exp2`` is not exact at or below -15 (ROADMAP queue 3), and
    the errors of a real step have groups far below their tensor's max."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp2(e):
        bits = (jnp.round(e).astype(jnp.int32) + 127) << 23
        return jax.lax.bitcast_convert_type(bits, jnp.float32)


def _jax_fake_op(x, w, g, stride, ref):
    fwd = lambda a, b: jlowbit.lowbit_conv(a, b, None, stride, "SAME", ref)  # noqa: E731
    y, vjp = jax.vjp(fwd, x, w)
    return (y, *vjp(g))




# GoogleNet's convs are held one by one in its stem and in inception
# modules 3a, 4a and 5b (the first at 32x32, after each max pool; each with
# all six branches, 1x1, 3x3 and 5x5): its other modules repeat those ops at
# other widths, and each held conv costs a JAX compile
_GOOGLENET_MODULES = (0, 2, 8)


def _check_groups(got, want, groups: int, col2im_5x5: bool, what: str) -> None:
    """Bit for bit when the GEMM has one scaling group and no 5x5 col2im;
    else within ``(G - 1) eps max|ref|`` for the G-term group sum (the jnp
    oracle adds its groups with ``jnp.sum``, the Pallas kernel and the port
    in k order) plus ``25 eps max|ref|`` for a 5x5 col2im."""
    eps, top = np.finfo(np.float32).eps, float(np.abs(want).max())
    atol = ((groups - 1) + (25 if col2im_5x5 else 0)) * eps * top
    if atol == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol, err_msg=what)


@pytest.mark.parametrize("backend", ["quantized", "fake_quant"])
@pytest.mark.parametrize("arch", ZOO)
def test_quantized_convs_of_a_step_match_jax(arch, backend, jax_params, monkeypatch):
    fmt = EMFormat(2, 4)
    qcfg = QuantConfig(fmt=fmt, k_block=32, stochastic=False, backend=backend,
                       conv_impl="im2col")
    ref = JQuantConfig(fmt=jformats.EMFormat(2, 4), k_block=32, stochastic=False,
                       backend="pallas" if backend == "quantized" else "fake_quant",
                       conv_impl="im2col")
    monkeypatch.setattr(jq, "jnp", _ExactExp2())
    fused_fwd = jax.jit(lowbit_conv_fused_ref, static_argnums=(2, 3, 4, 5))
    fused_grads = jax.jit(conv_fused_grads_ref, static_argnums=(3, 4, 5, 6))
    fake = jax.jit(_jax_fake_op, static_argnums=(3, 4))
    records = _captured_convs(arch, jax_params[arch], qcfg)
    n_quantized = sum(1 for k, d in cnn.count_ops(
        cnn.CNNConfig(arch, width_mult=SIZES[arch][0], in_hw=SIZES[arch][1])) if k == "conv") - 1
    assert len(records) == n_quantized and all("g" in r for r in records)
    for i, rec in enumerate(records):
        if arch == "googlenet" and not (i < 2 or (i - 2) // 6 in _GOOGLENET_MODULES):
            continue
        y, dx, dw = _port_op(rec, qcfg)
        x, w, g = (jnp.asarray(rec[k].numpy()) for k in ("x", "w", "g"))
        kh = w.shape[2]
        if backend == "quantized":
            y_ref = np.asarray(fused_fwd(x, w, None, rec["stride"], "SAME", ref))
            dx_ref, dw_ref = (np.asarray(t) for t in fused_grads(
                x, w, g, None, rec["stride"], "SAME", ref))
            n, c, _, _ = rec["x"].shape
            o, _, oh, ow = rec["g"].shape
            # (result, reference, contraction length, col2im of a 5x5 window)
            for what, got, want, k, c2i in (("y", y, y_ref, c * kh * kh, False),
                                            ("dw", dw, dw_ref, n * oh * ow, False),
                                            ("dx", dx, dx_ref, o, kh > 3)):
                _check_groups(got, want, -(-k // 32), c2i, f"conv {i} {what}")
        else:
            for got, want, what in zip((y, dx, dw), fake(x, w, g, rec["stride"], ref),
                                       ("y", "dx", "dw")):
                want = np.asarray(want)
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                           err_msg=f"conv {i} {what}")
