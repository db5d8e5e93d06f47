"""The port's quantized-domain conv and matmul (kernels.lowbit_conv on the
CPU, i.e. through the plain versions of the CUDA kernels) against the JAX
package's oracles ``lowbit_conv_fused_ref`` / ``conv_fused_grads_ref`` and
``matmul_qd_ref`` / ``matmul_qd_grads_ref``: forward and both gradients,
bit-exact, with deterministic rounding.

The cases are those of ``tests/test_conv_fused.py``: odd channels,
stride-2 "SAME" (asymmetric padding), "VALID", a 1x1 conv and explicit
pads.  The port's gradients come from ``torch.autograd`` through
``LowbitConvFused``; the JAX side uses the same cotangent.  One stated
exception: the input gradient of the 5x5 case, whose col2im sum XLA orders
its own way (see the test).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.kernels import (  # noqa: E402
    conv_fused_grads_ref,
    lowbit_conv_fused_ref,
    matmul_qd_grads_ref,
    matmul_qd_ref,
)
from repro_torch.core import EMFormat, QuantConfig  # noqa: E402
from repro_torch.kernels import conv_pads, lowbit_conv_fused, lowbit_matmul_qd  # noqa: E402

CASES = [
    # (N, C, H/W, O, ksize, stride, padding)
    (2, 5, 9, 7, 3, (1, 1), "SAME"),
    (2, 5, 9, 7, 3, (2, 2), "VALID"),
    (1, 3, 8, 4, 1, (1, 1), "SAME"),
    (2, 4, 10, 6, 3, (2, 1), "SAME"),
    (1, 7, 7, 5, 5, (1, 1), [(2, 2), (2, 2)]),
    (2, 4, 8, 6, 3, (2, 2), "SAME"),  # ResNet-20's downsampling conv
]
FORMATS = [(2, 4), (2, 1)]


def _cfgs(fmt, grouping="nc", k_block=32):
    ours = QuantConfig(fmt=EMFormat(*fmt), k_block=k_block, grouping=grouping,
                       stochastic=False)
    ref = JQuantConfig(fmt=jformats.EMFormat(*fmt), k_block=k_block, grouping=grouping,
                       stochastic=False, backend="pallas", conv_impl="im2col")
    return ours, ref


def _conv_inputs(seed, case):
    n, c, hw, o, k, stride, pad = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, hw, hw)).astype(np.float32)
    w = (rng.standard_normal((o, c, k, k)) * 0.2).astype(np.float32)
    return x, w, stride, pad


def _port_conv_and_grads(x, w, g, stride, pad, cfg):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = lowbit_conv_fused(xt, wt, None, stride, pad, cfg)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", CASES)
def test_conv_forward_and_grads_bitexact(fmt, case):
    x, w, stride, pad = _conv_inputs(0, case)
    ours, ref = _cfgs(fmt)
    y_ref = np.asarray(lowbit_conv_fused_ref(jnp.asarray(x), jnp.asarray(w), None, stride,
                                             pad, ref))
    g = np.random.default_rng(1).standard_normal(y_ref.shape).astype(np.float32)
    y, dx, dw = _port_conv_and_grads(x, w, g, stride, pad, ours)
    np.testing.assert_array_equal(y, y_ref)
    dx_ref, dw_ref = conv_fused_grads_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                                          None, stride, pad, ref)
    np.testing.assert_array_equal(dw, np.asarray(dw_ref))
    if case[4] <= 3:
        np.testing.assert_array_equal(dx, np.asarray(dx_ref))
    else:
        # col2im of a 5x5 window: XLA's CPU convolution adds the 25 taps in
        # an order of its own (neither row- nor column-major, forward or
        # reverse); the port adds them in one fixed order.  The difference
        # is the rounding of a 25-term fp32 sum.
        dx_ref = np.asarray(dx_ref)
        atol = 25 * np.finfo(np.float32).eps * np.abs(dx_ref).max()
        np.testing.assert_allclose(dx, dx_ref, rtol=0, atol=atol)


@pytest.mark.parametrize("grouping", ["c", "n", "none"])
def test_conv_groupings_bitexact(grouping):
    x, w, stride, pad = _conv_inputs(2, CASES[0])
    ours, ref = _cfgs((2, 4), grouping)
    y_ref = np.asarray(lowbit_conv_fused_ref(jnp.asarray(x), jnp.asarray(w), None, stride,
                                             pad, ref))
    g = np.random.default_rng(3).standard_normal(y_ref.shape).astype(np.float32)
    y, dx, dw = _port_conv_and_grads(x, w, g, stride, pad, ours)
    np.testing.assert_array_equal(y, y_ref)
    dx_ref, dw_ref = conv_fused_grads_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                                          None, stride, pad, ref)
    np.testing.assert_array_equal(dx, np.asarray(dx_ref))
    np.testing.assert_array_equal(dw, np.asarray(dw_ref))


@pytest.mark.parametrize("fmt", FORMATS)
def test_matmul_qd_forward_and_grads_bitexact(fmt):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 20, 50)).astype(np.float32)
    w = (rng.standard_normal((50, 30)) * 0.1).astype(np.float32)
    ours, ref = _cfgs(fmt)
    y_ref = np.asarray(matmul_qd_ref(jnp.asarray(x), jnp.asarray(w), None, ref))
    g = rng.standard_normal(y_ref.shape).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = lowbit_matmul_qd(xt, wt, None, ours)
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), y_ref)
    dx_ref, dw_ref = matmul_qd_grads_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g),
                                         None, ref)
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_ref))
    np.testing.assert_array_equal(wt.grad.numpy(), np.asarray(dw_ref))


def test_stochastic_rounding_is_seeded_per_key():
    """Same key, same result; another key, other rounding (the streams are
    the port's own, so there is no bit-level comparison with JAX here)."""
    x, w, stride, pad = _conv_inputs(5, CASES[0])
    cfg = QuantConfig(fmt=EMFormat(2, 4), k_block=32, stochastic=True)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    y1 = lowbit_conv_fused(xt, wt, 11, stride, pad, cfg)
    y2 = lowbit_conv_fused(xt, wt, 11, stride, pad, cfg)
    y3 = lowbit_conv_fused(xt, wt, 12, stride, pad, cfg)
    assert torch.equal(y1, y2)
    assert not torch.equal(y1, y3)
    y_det = lowbit_conv_fused(xt, wt, None, stride, pad, cfg)  # no key: nearest
    y_fp = torch.nn.functional.conv2d(xt, wt, padding=1)
    for y in (y1, y_det):
        assert float((y - y_fp).norm() / y_fp.norm()) < 0.08


@pytest.mark.parametrize("case", CASES)
def test_conv_pads_follow_jax_rule(case):
    from jax import lax

    n, c, hw, o, k, stride, pad = case
    want = pad if not isinstance(pad, str) else lax.padtype_to_pads((hw, hw), (k, k), stride,
                                                                    pad)
    assert conv_pads((hw, hw), (k, k), stride, pad) == tuple(tuple(p) for p in want)
