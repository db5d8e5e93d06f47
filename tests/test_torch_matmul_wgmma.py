"""K3's wgmma variant (``csrc/mls_matmul.cu``: ``mls_matmul_decode`` then
``mls_matmul_wgmma``) on the CPU: its arithmetic emulated step by step
against the port's ``mls_matmul`` and the JAX package's kernel, its plan
rule, its launch descriptors and its tuning candidates.  The kernel itself
runs only on the card (``tests/test_torch_cuda.py``).

The emulation follows the kernel's order: the decode pass (both operands'
codes to int8 fractions, K-major: x as (M, K), w as (N, K) from the
weight's strided transposed view), one exact integer dot per group
(int64 products here, int32 in the tensor cores), then the k-order fold
``acc = fl(acc + fl(float(p) * fl(sx * sw)))`` and the tensor scale.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.kernels.mls_matmul import mls_matmul_pallas  # noqa: E402
from repro.kernels.ref import mls_matmul_ref as jax_matmul_ref  # noqa: E402
from repro_torch.analysis import kernel_verify as kv  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import EMFormat  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import decode_frac_int, mls_matmul, mls_quantize  # noqa: E402
from repro_torch.kernels.mls_matmul import (  # noqa: E402
    TILE,
    WGMMA_BN,
    MatmulPlan,
    _checked_plan,
    launch_spec,
    matmul_plan,
    tuned_plan,
)

WG = MatmulPlan("wgmma", "int8", WGMMA_BN, 0)
FORMATS = {"e2m4": EMFormat(2, 4), "e2m1": EMFormat(2, 1), "e0m4": EMFormat(0, 4)}
GROUPINGS = ["nc", "c", "n", "none"]
F = EMFormat(2, 4)


def _codes(seed, m, k, n, fmt, grouping, k_block):
    """Codes and scales of x (m, k) and of w (k, n), the weight quantized as
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


def _decode_scratch(x_codes, w_codes, fmt):
    """The decode pass's scratch: x fractions (M, K), then w fractions
    (N, K), int8, K-major and contiguous, from any strides."""
    fx = decode_frac_int(x_codes, fmt).to(torch.int8).contiguous()
    fw = decode_frac_int(w_codes, fmt).to(torch.int8).t().contiguous()
    return fx, fw


def _emulate(x_codes, x_sg, x_st, w_codes, w_sg, w_st, fmt, k_block):
    """The wgmma variant's arithmetic, step by step."""
    fx, fw = _decode_scratch(x_codes, w_codes, fmt)
    M, K = fx.shape
    N, groups = fw.shape[0], K // k_block
    sx, sw = x_sg.expand(M, groups), w_sg.expand(groups, N)
    acc = torch.zeros((M, N), dtype=torch.float32)
    for g in range(groups):
        ks = slice(g * k_block, (g + 1) * k_block)
        p = fx[:, ks].long() @ fw[:, ks].long().t()  # the group's exact dot
        assert int(p.abs().max()) < 2 ** 22  # the kernel's exact int -> float range
        s = sx[:, g:g + 1] * sw[g:g + 1, :]  # fl(sx * sw)
        acc = acc + p.to(torch.float32) * s  # fl(acc + fl(float(p) * s))
    unit = torch.tensor(2.0 ** (2 * (fmt.e_min - fmt.m)), dtype=torch.float32)
    return acc * ((x_st.reshape(()) * w_st.reshape(())) * unit)


def _np(t):
    return jnp.asarray(t.contiguous().numpy())


@pytest.mark.parametrize("k_block", [128, 256])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_emulation_equals_the_port_and_jax(fmt, grouping, k_block):
    """Ragged M and N (37 x 29: less than one 128 x 128 tile), three groups;
    the emulation, the port's mls_matmul on the wgmma plan, its default
    plan and JAX's reference agree bit for bit, and JAX's Pallas kernel in
    interpret mode too at k_block 128."""
    f = FORMATS[fmt]
    M, N, K = 37, 29, 3 * k_block
    args = _codes(k_block + len(grouping), M, K, N, f, grouping, k_block)
    want = _emulate(*args, f, k_block)
    got = mls_matmul(*args, f, k_block, grouping, plan=WG)
    assert got.shape == (M, N) and torch.equal(got, want)
    assert torch.equal(mls_matmul(*args, f, k_block, grouping), want)
    jf = jformats.EMFormat(f.e, f.m)
    jargs = [_np(a) for a in args]
    ref = jax.jit(jax_matmul_ref, static_argnums=(6, 7))(*jargs, jf, k_block)
    np.testing.assert_array_equal(want.numpy(), np.asarray(ref))
    if k_block == 128:
        pallas = mls_matmul_pallas(*jargs, jf, k_block=k_block, block_m=16, block_n=16,
                                   grouping=grouping, interpret=True)
        np.testing.assert_array_equal(want.numpy(), np.asarray(pallas))


def test_decode_scratch_of_the_strided_weight_view():
    """The weight arrives as the transpose of a K-contiguous (N, K) tensor;
    the decode pass reads it through its strides and writes (N, K)
    fractions equal to decoding the (N, K) codes themselves."""
    xc, _, _, wc, _, _ = _codes(3, 5, 256, 7, F, "nc", 128)
    assert wc.stride() == (1, 256) and xc.stride() == (256, 1)
    fx, fw = _decode_scratch(xc, wc, F)
    assert fw.shape == (7, 256) and fw.is_contiguous()
    assert torch.equal(fw.to(torch.int32), decode_frac_int(wc.t().contiguous(), F))
    assert torch.equal(fx.to(torch.int32), decode_frac_int(xc, F))
    assert int(fw.abs().max()) <= F.max_fraction <= 127


def test_all_zero_operand_gives_zeros():
    xc, xsg, xst, wc, wsg, wst = _codes(4, 40, 256, 30, F, "nc", 128)
    zeros = torch.zeros_like(xc)
    out = mls_matmul(zeros, xsg, xst, wc, wsg, wst, F, 128, "nc", plan=WG)
    assert torch.equal(out, _emulate(zeros, xsg, xst, wc, wsg, wst, F, 128))
    assert not out.any() and not torch.signbit(out).any()


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------
# (M, K, N) at k_block 128, as qd_gemm pads K: chatglm3-6b's w_up forward,
# data and weight gradient at 8192 tokens, and zamba2-7b's model-2 rank
# shapes (in_proj and out_proj forwards, the in_proj weight gradient)
WGMMA_GEMMS = {"chatglm3 w_up fwd": (8192, 4096, 13696),
               "chatglm3 w_up dgrad": (8192, 13696, 4096),
               "chatglm3 w_up wgrad": (4096, 8192, 13696),
               "zamba2 in_proj fwd rank 0": (4096, 3584, 7408),
               "zamba2 out_proj fwd rank 0": (4096, 3584, 3584),
               "zamba2 in_proj wgrad rank 0": (3584, 4096, 7408)}


@pytest.mark.parametrize("name", sorted(WGMMA_GEMMS))
def test_plan_picks_wgmma_at_the_lm_shapes(name):
    M, K, N = WGMMA_GEMMS[name]
    plan = matmul_plan(M, N, K, 128, F)
    assert (plan.variant, plan.body, plan.bn) == ("wgmma", "int8", 128)
    assert plan.workspace_bytes == (M + N) * K  # the decode scratch
    assert _checked_plan(WG, M, N, K, 128, F) == plan


def test_plan_keeps_the_walk_and_split_elsewhere():
    from test_torch_matmul import PLANS, _resnet20_gemms

    for kb in (128, 144):
        for name, (M, K, N) in _resnet20_gemms(kb).items():
            plan = matmul_plan(M, N, K, kb, F)
            assert (plan.variant, plan.bn, plan.workspace_bytes) == PLANS[kb][name]
    for N, K in ((13696, 4096), (4096, 13696), (4096, 4096)):  # decode at M = 4
        assert matmul_plan(4, N, K, 128, F).variant in ("walk", "split")
    assert matmul_plan(8208, 13680, 4032, 144, F).variant == "walk"  # k_block 144
    wide = matmul_plan(8192, 13696, 4096, 128, EMFormat(3, 1))  # <3,1>: fractions 192
    assert (wide.variant, wide.body) == ("walk", "int32")
    assert matmul_plan(512, 512, 7168, 128, F).variant == "wgmma"  # 16 tiles, 56 groups
    assert matmul_plan(512, 384, 7168, 128, F).variant != "wgmma"  # 12 tiles
    assert matmul_plan(8192, 576, 128, 128, F).variant == "walk"  # one group


@pytest.mark.parametrize("case,match", [
    ((MatmulPlan("wgmma", "int32", 128, 0), EMFormat(3, 1), 128), "int8"),
    ((MatmulPlan("wgmma", "int8", 128, 0), EMFormat(2, 4), 192), "k_block=192"),
    ((MatmulPlan("wgmma", "int8", 64, 0), EMFormat(2, 4), 128), "unknown K3 plan"),
    ((MatmulPlan("wgmma", "int8", 128, 0), EMFormat(2, 4), 384), "2\\^22"),
    ((MatmulPlan("wgmma", "int8", 128, 0), EMFormat(2, 4), "grid"), "grid limit"),
])
def test_checked_plan_refuses_what_wgmma_cannot_run_exactly(case, match):
    plan, fmt, kb = case
    M, N = 256, 256
    if kb == "grid":  # the decode grid's 65535 row tiles of 128
        kb, N = 128, 65536 * TILE["kDecRows"]
    with pytest.raises(ValueError, match=match):
        _checked_plan(plan, M, N, 2 * kb, kb, fmt)
    with pytest.raises(ValueError, match=match):
        tuned_plan("wgmma", plan.bn, M, N, 2 * kb, kb, fmt)


def test_a_wgmma_plan_the_kernel_cannot_run_raises_in_the_wrapper():
    args = _codes(6, 8, 384, 4, EMFormat(2, 4), "nc", 384)
    with pytest.raises(ValueError, match="2\\^22"):
        mls_matmul(*args, EMFormat(2, 4), 384, "nc", plan=WG)


# ---------------------------------------------------------------------------
# launch descriptors, tuning candidates, the shape-only path
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(WGMMA_GEMMS))
def test_launch_spec_proves_at_the_lm_shapes(name):
    M, K, N = WGMMA_GEMMS[name]
    decode, dots = launch_spec(M, N, K, 128, "nc", F)
    assert (decode.kernel, decode.sequential) == ("mls_matmul_decode", 0)
    assert (dots.kernel, dots.sequential) == ("mls_matmul_wgmma", 1)
    assert dots.shape == (-(-M // 128), -(-N // 128), K // 128)
    assert (decode.macs, dots.macs) == (0, M * N * K)
    rep = kv.verify_specs(name, [(decode, 1), (dots, 1)])
    assert rep.ok, rep.violations
    assert all(c.exhaustive for c in rep.calls) and rep.max_integer_bits <= 23
    xf, wf = rep.calls[0].coverage["outputs[1]"], rep.calls[0].coverage["outputs[2]"]
    assert xf["blocks_written"] == xf["output_blocks"] == -(-M // 128) * (K // 128)
    assert wf["blocks_written"] == wf["output_blocks"] == -(-N // 128) * (K // 128)
    assert xf["max_writers"] == wf["max_writers"] == 1
    out = rep.calls[1].coverage["outputs[0]"]
    assert out["max_writers"] == 1 and out["revisit_depth"] == K // 128


def test_launch_spec_at_a_ragged_shape_and_the_audit_section():
    decode, dots = launch_spec(200, 136, 1024, 128, "c", F, plan=WG)
    rep = kv.verify_specs("ragged", [(decode, 1), (dots, 1)])
    assert rep.ok and dots.shape == (2, 2, 8)
    names = {s.kernel for s, _ in kv.lm_train_specs(get_config("chatglm3-6b"), 8192)}
    assert {"mls_matmul_decode", "mls_matmul_wgmma", "quantize_amax"} <= names


def test_autotune_candidates_hold_wgmma_only_where_legal():
    big = at.TuneSpec("gemm", (8192, 4096, 13696), F)
    cands = at.gemm_candidates(big)
    assert cands[0] == at.BlockConfig("wgmma", 128) == at.default_block_config(big)
    assert {c.variant for c in cands} == {"wgmma", "walk"}
    assert at.verify_config(big, at.BlockConfig("wgmma", 128)).ok
    for spec in (at.TuneSpec("gemm", (8192, 4032, 13680), F, 144),  # k_block 144
                 at.TuneSpec("gemm", (8192, 4096, 13696), EMFormat(3, 1)),  # int32 body
                 at.TuneSpec("gemm", (4, 4096, 13696), F)):  # legal, slower: still tuned
        has = any(c.variant == "wgmma" for c in at.gemm_candidates(spec))
        assert has == (spec.shape[0] == 4)
    bad = at.verify_config(at.TuneSpec("gemm", (8192, 4096, 13696), EMFormat(3, 1)),
                           at.BlockConfig("wgmma", 128))
    assert not bad.ok and "int8" in bad.first_violation()
    with pytest.raises(ValueError):
        at.BlockConfig("walk", 128)
    assert at.BlockConfig.from_json(at.BlockConfig("wgmma", 128).to_json()).bn == 128


def test_shape_only_path_allocates_the_decode_scratch():
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.kernels import launch, launch_counts
    from repro_torch.launch.trace_counts import BLOCK, StepCounter

    M, K, N = 512, 1024, 2048
    plan = matmul_plan(M, N, K, 128, F)
    assert plan.variant == "wgmma"
    before = launch_counts()
    launch.RECORDED.clear()
    counter = StepCounter()
    with FakeTensorMode():
        xc = torch.empty((M, K), dtype=torch.uint8, device="cuda")
        wc = torch.empty((N, K), dtype=torch.uint8, device="cuda")
        xsg = torch.empty((M, K // 128), device="cuda")
        wsg = torch.empty((N, K // 128), device="cuda")
        st = torch.empty((), device="cuda")
        wct, wsgt = wc.t(), wsg.t()
        with counter:
            base = counter.current()
            y = mls_matmul(xc, xsg, st, wct, wsgt, st, F, 128, "nc")
    assert (y.shape, y.dtype, y.device.type) == ((M, N), torch.float32, "cuda")
    # the output and the (M + N) * K-byte scratch, both alive at the peak
    assert counter.peak - base == BLOCK * -(-M * N * 4 // BLOCK) + BLOCK * -(-(M + N) * K // BLOCK)
    assert launch_counts() == before
    assert ("mls_matmul", "cuda", M, N, K, 128, "nc", F, plan) in launch.RECORDED
