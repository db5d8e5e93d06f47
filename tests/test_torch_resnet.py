"""The port's ResNet-20 training step against the JAX package's, on the CPU.

The parameters are the JAX package's own initialisation, converted with
``repro_torch.convert.resnet_params_from_jax``; the batch is made with
numpy.  The JAX step runs ``apply_cnn`` with the quantized-domain backend
bound to its jnp oracles (``REF_BACKEND``, patched in for the test only),
the port's step runs ``ResNet.forward`` through the plain versions of its
CUDA kernels.

Tolerance: loss within 1e-5 relative, logits within 1e-5 absolute, and
for every parameter a gradient cosine >= 1 - 1e-6 and a relative error
(``||g - g_jax|| / ||g_jax||``) <= 1e-4.  The quantized convs are bit-exact
by themselves (``test_torch_lowbit_conv.py``), but the fp32 stem conv, BN
and the classifier reduce in another order in the two frameworks, so the
results differ in their last bits.  The inputs are fixed and both runs are
deterministic, so each limit sits about 20-100x above what these inputs
give: loss equal to 7e-8 relative, logits within 5e-7, every gradient
cosine above 1 - 3e-13 and every relative error below 1.3e-6.  A real bug
in BN (eps, variance form) or in one leaf's gradient exceeds them.  The
same limits hold at k_block 36, where the port's 18 3x3 convs take the
implicit-GEMM forward and the JAX step stays on im2col.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.lowbit_conv as jlowbit_conv  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.data.synthetic import _class_pattern  # noqa: E402
from repro.models.cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.cnn import apply_cnn, init_cnn  # noqa: E402
from repro.optim.optimizers import sgdm_init, sgdm_update  # noqa: E402
from repro.optim.optimizers import step_decay_schedule as jstep_decay  # noqa: E402
from repro_torch.convert import resnet_params_from_jax  # noqa: E402
from repro_torch.core import EMFormat, QuantConfig  # noqa: E402
from repro_torch.data.synthetic import CifarIterator, class_pattern  # noqa: E402
from repro_torch.kernels import conv_geometry, resolve_conv_impl  # noqa: E402
from repro_torch.models.cnn import CNNConfig, ResNet  # noqa: E402
from repro_torch.models.cnn import init_cnn as init_port_cnn  # noqa: E402
from repro_torch.optim.optimizers import sgdm, step_decay_schedule  # noqa: E402

WIDTH, HW, BATCH, K_BLOCK = 0.25, 8, 2, 32
# k_block 36 = 4 channels x 3x3 taps: every 3x3 conv (C = 4, 8, 16) takes
# the implicit-GEMM forward ("auto"), the 1x1 projections stay on im2col
K_BLOCK_IMPLICIT = 36


@pytest.fixture(scope="module")
def jax_params():
    cfg = JCNNConfig("resnet20", width_mult=WIDTH, in_hw=HW)
    return jax.tree.map(np.asarray, jax.jit(lambda k: init_cnn(k, cfg))(jax.random.key(0)))


def _model(params_np) -> ResNet:
    model = ResNet(CNNConfig("resnet20", width_mult=WIDTH, in_hw=HW))
    model.load_state_dict(resnet_params_from_jax(params_np), strict=True)
    return model


def test_converter_covers_the_jax_tree_one_to_one(jax_params):
    sd = resnet_params_from_jax(jax_params)
    flat = jax.tree_util.tree_flatten_with_path(jax_params)[0]
    assert len(sd) == len(flat)
    for path, leaf in flat:
        name = ".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)
        assert tuple(sd[name].shape) == leaf.shape, name
    model = ResNet(CNNConfig("resnet20", width_mult=WIDTH, in_hw=HW))
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == {
        n: tuple(t.shape) for n, t in sd.items()}
    # 20 quantized convs: 18 3x3 in the blocks, 2 1x1 projections
    convs = [n for n in sd if n.startswith("blocks") and n.endswith(".w")]
    assert len(convs) == 20


@pytest.mark.parametrize("fmt,k_block", [
    pytest.param((2, 4), K_BLOCK, id="fmt0"),
    pytest.param((2, 1), K_BLOCK, id="fmt1"),
    pytest.param((2, 4), K_BLOCK_IMPLICIT, id="fmt0-implicit"),
    pytest.param((2, 1), K_BLOCK_IMPLICIT, id="fmt1-implicit"),
])
def test_train_step_matches_jax(jax_params, monkeypatch, fmt, k_block):
    monkeypatch.setattr(jlowbit_conv, "PALLAS_BACKEND", jlowbit_conv.REF_BACKEND)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((BATCH, 3, HW, HW)).astype(np.float32)
    labels = np.array([3, 7])
    jcfg = JCNNConfig("resnet20", width_mult=WIDTH, in_hw=HW)
    jq = JQuantConfig(fmt=jformats.EMFormat(*fmt), k_block=k_block, stochastic=False,
                      backend="pallas", conv_impl="im2col")

    def loss_fn(p):
        logits = apply_cnn(p, jnp.asarray(x), jcfg, jq, None)
        ll = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(ll, jnp.asarray(labels)[:, None], 1).mean(), logits

    (l_j, z_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, jax_params))

    model = _model(jax_params)
    qcfg = QuantConfig(fmt=EMFormat(*fmt), k_block=k_block, stochastic=False)
    impls = {resolve_conv_impl(conv_geometry(*c), qcfg) for c in _quantized_convs()}
    assert impls == ({"im2col", "implicit"} if k_block == K_BLOCK_IMPLICIT else {"im2col"})
    logits = model(torch.from_numpy(x), qcfg, None)
    loss = torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels))
    loss.backward()

    assert abs(loss.item() - float(l_j)) <= 1e-5 * abs(float(l_j))
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(z_j), rtol=0, atol=1e-5)
    grads_j = resnet_params_from_jax(jax.tree.map(np.asarray, g_j))
    for name, p in model.named_parameters():
        a, b = p.grad.flatten().double(), grads_j[name].flatten().double()
        cos = float(a @ b / (a.norm() * b.norm()))
        assert cos >= 1 - 1e-6, (name, cos)
        rel = float((a - b).norm() / b.norm())
        assert rel <= 1e-4, (name, rel)


def _quantized_convs():
    """(x shape, w shape, stride, padding) of the 20 quantized convs."""
    cfg = CNNConfig("resnet20", width_mult=WIDTH, in_hw=HW)
    model, hw, out = ResNet(cfg), HW, []
    for blk in model.blocks:
        c_in, c_out, s = blk.conv1.w.shape[1], blk.conv1.w.shape[0], blk.stride
        out.append(((BATCH, c_in, hw, hw), tuple(blk.conv1.w.shape), (s, s), "SAME"))
        if hasattr(blk, "proj"):
            out.append(((BATCH, c_in, hw, hw), tuple(blk.proj.w.shape), (s, s), "SAME"))
        hw = -(-hw // s)
        out.append(((BATCH, c_out, hw, hw), tuple(blk.conv2.w.shape), (1, 1), "SAME"))
    assert len(out) == 20
    return out


def test_sgdm_matches_jax_update():
    """torch.optim.SGD(momentum 0.9, wd 5e-4) is the JAX sgdm_update."""
    rng = np.random.default_rng(1)
    p0 = {"a": rng.standard_normal((4, 3)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    pj, st = jax.tree.map(jnp.asarray, p0), sgdm_init(p0)
    pt = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = sgdm(pt.values(), lr=0.05)
    for g in grads:
        pj, st = sgdm_update(jax.tree.map(jnp.asarray, g), st, pj, 0.05)
        for k, t in pt.items():
            t.grad = torch.from_numpy(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(pt[k].detach().numpy(), np.asarray(pj[k]), rtol=1e-6,
                                   atol=1e-7)


def test_step_decay_schedule_matches_jax():
    ours, ref = step_decay_schedule(0.05, [4, 6]), jstep_decay(0.05, [4, 6])
    for s in range(9):
        assert ours(s) == pytest.approx(float(ref(s)), rel=1e-6)


def test_class_pattern_matches_jax():
    """Same patterns; sin is evaluated by two libraries, hence 1e-6."""
    np.testing.assert_allclose(class_pattern(10, 12).numpy(), np.asarray(_class_pattern(10, 12)),
                               rtol=0, atol=1e-6)


def test_data_and_init_are_seeded():
    a, b = (next(CifarIterator(4, 8, seed=3, device="cpu")) for _ in range(2))
    assert torch.equal(a["image"], b["image"]) and torch.equal(a["label"], b["label"])
    assert a["image"].shape == (4, 3, 8, 8) and a["image"].dtype == torch.float32
    cfg = CNNConfig("resnet20", width_mult=WIDTH, in_hw=HW)
    m1, m2 = init_port_cnn(cfg, 5, "cpu"), init_port_cnn(cfg, 5, "cpu")
    for (n, p), q in zip(m1.named_parameters(), m2.parameters()):
        assert torch.equal(p, q), n


def test_train_loop_runs_on_cpu_and_counts_no_launches():
    """The trainer on the CPU takes its steps through the plain versions,
    so it launches no CUDA kernel; a loss stays finite."""
    from repro_torch.train.loop import train_variant

    qcfg = QuantConfig(fmt=EMFormat(2, 1), k_block=K_BLOCK, stochastic=True)
    res = train_variant("mls<2,1>", qcfg, 2, width=WIDTH, hw=HW, batch=4, device="cpu",
                        log=lambda *_: None)
    assert len(res.losses) == 2 and all(np.isfinite(res.losses))
    assert all(not any(per.values()) for per in res.launches)
