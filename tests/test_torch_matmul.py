"""The port's quantized-domain GEMM (kernels.mls_matmul on the CPU, i.e.
the plain version of the CUDA kernel) against the JAX package: bit-exact
against the TPU kernel in interpret mode and against ``mls_matmul_ref``,
for all four groupings, with ragged M/N and three or more k-blocks.

The port accumulates the groups in k order; ``mls_matmul_ref`` sums them
with one ``jnp.sum(axis=0)``, whose order XLA chooses.  On these shapes it
is the same order (the results are equal bit for bit).
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.kernels.mls_matmul import mls_matmul_pallas  # noqa: E402
from repro.kernels.ref import decode_frac_int as jax_decode  # noqa: E402
from repro.kernels.ref import mls_matmul_ref as jax_matmul_ref  # noqa: E402
from repro_torch.core import EMFormat  # noqa: E402
from repro_torch.kernels import decode_frac_int, mls_matmul, mls_quantize, sg_shapes  # noqa: E402

GROUPINGS = ["nc", "c", "n", "none"]


def _codes(seed, m, k, n, fmt, grouping, k_block=32):
    """Codes/scales of x (m, k) and of w (k, n), the weight quantized as
    (n, k) and handed over transposed, as qd_gemm does."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((m, k)) * rng.uniform(0.3, 2, (m, 1)))
                         .astype(np.float32))
    wt = torch.from_numpy(rng.standard_normal((n, k)).astype(np.float32))
    r_x = torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8))
    r_w = torch.from_numpy(rng.integers(0, 256, (n, k), dtype=np.uint8))
    xc, xsg, xst = mls_quantize(x, fmt, k_block, r_u8=r_x, grouping=grouping)
    wc, wsgT, wst = mls_quantize(wt, fmt, k_block, r_u8=r_w, grouping=grouping)
    return xc, xsg, xst, wc.t(), wsgT.t(), wst


def _np(t):
    return jnp.asarray(t.contiguous().numpy())


@pytest.mark.parametrize("e,m", [(2, 4), (2, 1), (0, 4)])
def test_decode_frac_int_matches_jax(e, m):
    codes = np.arange(2 ** (1 + e + m), dtype=np.uint8)
    got = decode_frac_int(torch.from_numpy(codes), EMFormat(e, m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_decode(jnp.asarray(codes),
                                                                     jformats.EMFormat(e, m))))
    assert int(got.abs().max()) == EMFormat(e, m).max_fraction


@pytest.mark.parametrize("fmt", [(2, 4), (2, 1)])
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_mls_matmul_matches_pallas_kernel_and_ref(fmt, grouping):
    M, K, N = 37, 96, 29  # ragged M/N, three k-blocks of 32
    args = _codes(0, M, K, N, EMFormat(*fmt), grouping)
    got = mls_matmul(*args, EMFormat(*fmt), 32, grouping)
    assert got.shape == (M, N) and got.dtype == torch.float32
    jargs = [_np(a) for a in args]
    pallas = mls_matmul_pallas(*jargs, jformats.EMFormat(*fmt), k_block=32, block_m=16,
                               block_n=16, grouping=grouping, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))
    ref = jax_matmul_ref(*jargs, jformats.EMFormat(*fmt), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mls_matmul_deep_contraction_matches_ref():
    """Sixteen k-blocks: the k-order accumulation still equals the JAX
    reference's sum."""
    args = _codes(1, 20, 512, 12, EMFormat(2, 4), "nc")
    got = mls_matmul(*args, EMFormat(2, 4), 32, "nc")
    ref = jax_matmul_ref(*[_np(a) for a in args], jformats.EMFormat(2, 4), 32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_mls_matmul_tracks_float_product():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 128)).astype(np.float32)
    w = rng.standard_normal((128, 48)).astype(np.float32)
    fmt = EMFormat(2, 4)
    xc, xsg, xst = mls_quantize(torch.from_numpy(x), fmt, 32)
    wc, wsgT, wst = mls_quantize(torch.from_numpy(np.ascontiguousarray(w.T)), fmt, 32)
    y = mls_matmul(xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, 32).numpy()
    rel = np.linalg.norm(y - x @ w) / np.linalg.norm(x @ w)
    assert rel < 0.05, rel


def test_mls_matmul_rejects_bad_operands():
    fmt = EMFormat(2, 4)
    xc, xsg, xst, wc, wsg, wst = _codes(3, 8, 64, 4, fmt, "nc")
    assert sg_shapes("nc", 8, 4, 2) == (tuple(xsg.shape), tuple(wsg.shape))
    with pytest.raises(ValueError, match="layout mismatch"):
        mls_matmul(xc, xsg, xst, wc, wsg, wst, fmt, 32, "c")
    with pytest.raises(ValueError, match="multiple of k_block"):
        mls_matmul(xc, xsg, xst, wc, wsg, wst, fmt, 48, "nc")
    with pytest.raises(ValueError, match="exact fp32 range"):
        mls_matmul(xc, xsg[:, :1], xst, wc, wsg[:1], wst, EMFormat(3, 4), 64, "nc")
    with pytest.raises(ValueError, match="uint8"):
        mls_matmul(xc.int(), xsg, xst, wc, wsg, wst, fmt, 32, "nc")
