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
from repro_torch.core import EMFormat, accumulation_bits  # noqa: E402
from repro_torch.kernels import decode_frac_int, mls_matmul, mls_quantize, sg_shapes  # noqa: E402
from repro_torch.kernels.mls_matmul import MatmulPlan, matmul_plan  # noqa: E402

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


# ---------------------------------------------------------------------------
# K3's plan and its ordered split
# ---------------------------------------------------------------------------
def _terms_then_sum(xc, xsg, xst, wc, wsg, wst, fmt, k_block):
    """K3's split in torch: phase 1 stores each group's rounded term
    fl(float(p) * fl(sx * sw)), p the exact integer dot (int8 operands where
    the format's fractions fit); phase 2 adds the terms in k order from +0.0,
    then applies the tensor scale."""
    M, K = xc.shape
    N = wc.shape[1]
    G = K // k_block
    fx, fw = decode_frac_int(xc, fmt), decode_frac_int(wc, fmt)
    if fmt.max_fraction <= 127:  # the int8 body's operands hold every fraction
        assert torch.equal(fx.to(torch.int8).to(torch.int32), fx)
        assert torch.equal(fw.to(torch.int8).to(torch.int32), fw)
    xs, ws = xsg.expand(M, G), wsg.expand(G, N)
    terms = torch.empty((G, M, N))
    for g in range(G):
        ks = slice(g * k_block, (g + 1) * k_block)
        p = fx[:, ks].long() @ fw[ks, :].long()
        assert int(p.abs().max()) < 2**24
        terms[g] = p.float() * (xs[:, g : g + 1] * ws[g : g + 1, :])
    acc = torch.full((M, N), 0.0)
    for g in range(G):
        acc = acc + terms[g]
    unit = 2.0 ** (2 * (fmt.e_min - fmt.m))
    return acc * ((xst.reshape(()) * wst.reshape(())) * unit)


@pytest.mark.parametrize("fmt", [(2, 4), (2, 1), (0, 4), (3, 1)])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("mkn_g", [(37, 29, 3), (20, 70, 5)])
def test_terms_then_ordered_sum_equals_the_reference(fmt, grouping, mkn_g):
    """The split's two phases give mls_matmul_ref's bits (and the JAX
    reference's): the same products and the same sums in the same order."""
    M, N, G = mkn_g
    kb = 32
    fmt_t = EMFormat(*fmt)
    args = _codes(4, M, G * kb, N, fmt_t, grouping)
    got = _terms_then_sum(*args, fmt_t, kb)
    torch_ref = mls_matmul(*args, fmt_t, kb, grouping)
    jax_ref = jax_matmul_ref(*[_np(a) for a in args], jformats.EMFormat(*fmt), kb)
    assert torch.equal(got, torch_ref)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref))


def _resnet20_gemms(k_block: int) -> dict[str, tuple[int, int, int]]:
    """(M, K, N) of full-width ResNet-20's distinct GEMMs at batch 128, K
    padded to a multiple of k_block as qd_gemm pads it: per conv the forward
    (patches @ weight), weight gradient (patches^T @ error) and data gradient
    (error @ weight^T)."""
    pad = lambda k: -(-k // k_block) * k_block  # noqa: E731
    convs = {"s1": (131072, 144, 16), "s2_conv1": (32768, 144, 32), "s2_proj": (32768, 16, 32),
             "s2": (32768, 288, 32), "s3_conv1": (8192, 288, 64), "s3_proj": (8192, 32, 64),
             "s3": (8192, 576, 64)}  # (M0 = N*OH*OW, K0 = C*kh*kw, O)
    gemms = {}
    for name, (m0, k0, o) in convs.items():
        gemms[f"{name}_fwd"] = (m0, pad(k0), o)
        gemms[f"{name}_wgrad"] = (k0, pad(m0), o)
        gemms[f"{name}_dgrad"] = (m0, pad(o), k0)
    return gemms


# name -> (variant, bn, workspace bytes) at k_block 128 and 144; the split
# runs where fewer than 132 output tiles of 64 x bn would leave SMs idle
# and there is more than one group; its workspace is G * M * N * 4 bytes
PLANS = {
    128: {"s1_fwd": ("walk", 16, 0), "s1_wgrad": ("split", 16, 1024 * 144 * 16 * 4),
          "s1_dgrad": ("walk", 64, 0),
          "s2_conv1_fwd": ("walk", 32, 0), "s2_conv1_wgrad": ("split", 32, 256 * 144 * 32 * 4),
          "s2_conv1_dgrad": ("walk", 64, 0),
          "s2_proj_fwd": ("walk", 32, 0), "s2_proj_wgrad": ("split", 32, 256 * 16 * 32 * 4),
          "s2_proj_dgrad": ("walk", 16, 0),
          "s2_fwd": ("walk", 32, 0), "s2_wgrad": ("split", 32, 256 * 288 * 32 * 4),
          "s2_dgrad": ("walk", 64, 0),
          "s3_conv1_fwd": ("split", 64, 3 * 8192 * 64 * 4),
          "s3_conv1_wgrad": ("split", 64, 64 * 288 * 64 * 4), "s3_conv1_dgrad": ("walk", 64, 0),
          "s3_proj_fwd": ("walk", 64, 0), "s3_proj_wgrad": ("split", 64, 64 * 32 * 64 * 4),
          "s3_proj_dgrad": ("walk", 32, 0),
          "s3_fwd": ("split", 64, 5 * 8192 * 64 * 4), "s3_wgrad": ("split", 64, 64 * 576 * 64 * 4),
          "s3_dgrad": ("walk", 64, 0)},
    144: {"s1_fwd": ("walk", 16, 0), "s1_wgrad": ("split", 16, 911 * 144 * 16 * 4),
          "s1_dgrad": ("walk", 64, 0),
          "s2_conv1_fwd": ("walk", 32, 0), "s2_conv1_wgrad": ("split", 32, 228 * 144 * 32 * 4),
          "s2_conv1_dgrad": ("walk", 64, 0),
          "s2_proj_fwd": ("walk", 32, 0), "s2_proj_wgrad": ("split", 32, 228 * 16 * 32 * 4),
          "s2_proj_dgrad": ("walk", 16, 0),
          "s2_fwd": ("walk", 32, 0), "s2_wgrad": ("split", 32, 228 * 288 * 32 * 4),
          "s2_dgrad": ("walk", 64, 0),
          "s3_conv1_fwd": ("split", 64, 2 * 8192 * 64 * 4),
          "s3_conv1_wgrad": ("split", 64, 57 * 288 * 64 * 4), "s3_conv1_dgrad": ("walk", 64, 0),
          "s3_proj_fwd": ("walk", 64, 0), "s3_proj_wgrad": ("split", 64, 57 * 32 * 64 * 4),
          "s3_proj_dgrad": ("walk", 32, 0),
          "s3_fwd": ("split", 64, 4 * 8192 * 64 * 4), "s3_wgrad": ("split", 64, 57 * 576 * 64 * 4),
          "s3_dgrad": ("walk", 64, 0)},
}


@pytest.mark.parametrize("k_block", [128, 144])
@pytest.mark.parametrize("name", sorted(PLANS[128]))
def test_matmul_plan_at_every_resnet20_gemm(k_block, name):
    M, K, N = _resnet20_gemms(k_block)[name]
    plan = matmul_plan(M, N, K, k_block, EMFormat(2, 4))
    assert (plan.variant, plan.bn, plan.workspace_bytes) == PLANS[k_block][name]
    assert plan.body == "int8"
    if plan.variant == "split":
        assert plan.workspace_bytes == (K // k_block) * M * N * 4
    # <3,1> fractions reach 192: the same plan on the int32 body
    if accumulation_bits(EMFormat(3, 1), k_block) < 24:
        wide = matmul_plan(M, N, K, k_block, EMFormat(3, 1))
        assert (wide.variant, wide.body, wide.bn) == (plan.variant, "int32", plan.bn)


def test_matmul_plan_refuses_what_the_kernel_cannot_run_exactly():
    fmt = EMFormat(3, 1)
    args = _codes(5, 8, 64, 4, fmt, "nc")
    with pytest.raises(ValueError, match="beyond int8"):
        mls_matmul(*args, fmt, 32, "nc", plan=MatmulPlan("walk", "int8", 16, 0))
    with pytest.raises(ValueError, match="unknown K3 plan"):
        mls_matmul(*args, fmt, 32, "nc", plan=MatmulPlan("walk", "int32", 48, 0))
    got = mls_matmul(*args, fmt, 32, "nc", plan=MatmulPlan("split", "int32", 16, 0))
    assert torch.equal(got, mls_matmul(*args, fmt, 32, "nc"))
    with pytest.raises(ValueError, match="multiple of k_block"):
        matmul_plan(8, 4, 60, 32, fmt)
