"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one: a CUDA kernel has no CPU mode.  On a machine with a GPU and without
JAX, run them with

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Besides: the planted-overlap control K5 against its plain version (NaN
gaps, each written element bit-identical to one of its two racing
writers, a store probe of 2 per element where two programs write), the
built library's tile constants against the launch descriptors' copies,
and the launch specs of one full-width ResNet-20 step verifying clean.
Every choice the tile cache may make (``autotune.candidates_for``) at the
ResNet-20 stage shapes, a ragged shape, k_block 144, four groupings,
<2,4>/<2,1>/<3,1> and two LM decode shapes gives the default's bits and
the plain version's; the committed seed cache checks on the card.

Small, ragged shapes that the main path's shapes in ``chip_smoke.py`` do
not reach: M and N off the GEMM tile, both K3 plans (walk and ordered
split) on both bodies (int8 tensor cores; int32 for <3,1>), k_blocks off
the 16-wide k step, operands whose k axis is not contiguous; for K1
groups wider than a warp's limit, widths off the 4-wide vector access,
all-zero and -0.0 operands and a tensor max over many stride steps; the
E=0 format; for K2 the path's tall, wide and (N*C*Hp, Wp) operands,
widths off 4, an all-zero operand and a NaN; and for the implicit conv
k-blocks off the 16-wide k step, several k-blocks, two output-channel
tiles, stride 2 with SAME (asymmetric) and VALID (uncovered tail)
padding, a 1x1 conv, ResNet-20's three stage convs, the int32 body and a
NaN.  torch.profiler shows that K2 and the implicit conv launch no
PyTorch kernel around their own.  Tolerance 0: the kernels reproduce the
plain versions bit for bit.
"""
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.graphs import cifar_train_graph  # noqa: E402
from repro_torch.analysis.kernel_verify import verify_specs, writers_per_block  # noqa: E402
from repro_torch.core import EMFormat, QuantConfig  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    implicit_conv_forward,
    launch,
    launch_counts,
    lowbit_conv_fused,
    mls_matmul,
    mls_quantize,
    recorded_specs,
    reset_launch_counts,
)
from repro_torch.kernels.mls_matmul import (  # noqa: E402
    WGMMA_BN,
    MatmulPlan,
    _checked_plan,
    matmul_plan,
)
from repro_torch.kernels.ref import sabotage_overlap_tiles  # noqa: E402
from repro_torch.kernels.sabotage import launch_spec as k5_spec  # noqa: E402
from repro_torch.kernels.sabotage import sabotage_overlap_matmul  # noqa: E402

pytestmark = pytest.mark.cuda

GROUPINGS = ["nc", "c", "n", "none"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _operand(seed, m, k):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * rng.uniform(0.2, 3.0, (m, 1))).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(rng.integers(0, 256, (m, k), dtype=np.uint8))


@pytest.mark.parametrize("fmt", [(2, 4), (2, 1), (0, 4)])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("shape", [(37, 96), (5, 2048)])
def test_quantize_kernel_matches_plain(cuda, fmt, grouping, shape):
    x, r = _operand(0, *shape)
    want = mls_quantize(x, EMFormat(*fmt), 32, r_u8=r, grouping=grouping)
    before = sum(launch_counts().values())
    got = mls_quantize(x.to(cuda), EMFormat(*fmt), 32, r_u8=r.to(cuda), grouping=grouping)
    torch.cuda.synchronize()
    assert sum(launch_counts().values()) == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("mkn", [(37, 96, 29), (70, 512, 130)])
def test_matmul_kernel_matches_plain(cuda, grouping, mkn):
    m, k, n = mkn
    fmt = EMFormat(2, 4)
    x, rx = _operand(1, m, k)
    wt, rw = _operand(2, n, k)
    xc, xsg, xst = mls_quantize(x, fmt, 32, r_u8=rx, grouping=grouping)
    wc, wsgT, wst = mls_quantize(wt, fmt, 32, r_u8=rw, grouping=grouping)
    args = (xc, xsg, xst, wc.t(), wsgT.t(), wst)
    want = mls_matmul(*args, fmt, 32, grouping)
    got = mls_matmul(*(a.to(cuda) for a in args), fmt, 32, grouping)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# (M, K, N, k_block, layout): "kmajor" both operands K-contiguous (the
# main path's: the weight the transposed view of a K-contiguous (N, K)
# tensor), "nmajor" the weight N-contiguous, "xT" x M-contiguous; the
# k_blocks of 128 and 256 also take the wgmma variant
PLAN_CASES = [(37, 96, 29, 32, "kmajor"), (70, 480, 130, 48, "nmajor"),
              (5, 108, 16, 36, "xT"), (20, 288, 64, 144, "kmajor"),
              (200, 1024, 136, 128, "kmajor"), (130, 768, 260, 256, "nmajor"),
              (300, 512, 200, 128, "xT")]
PLAN_PARAMS = [(fmt, case) for fmt in [(2, 4), (2, 1), (0, 4), (3, 1)] for case in PLAN_CASES
               if not (fmt == (3, 1) and case[3] in (144, 256))]  # <3,1>: 24 bits, refused


def _codes_on(cuda, fmt, grouping, m, k, n, kb, layout):
    """Codes and scales of x (m, k) and w (k, n) on the CPU and the card,
    laid out as ``layout`` says (the same values)."""
    x, rx = _operand(6, m, k)
    wt, rw = _operand(7, n, k)
    xc, xsg, xst = mls_quantize(x, fmt, kb, r_u8=rx, grouping=grouping)
    wc, wsgT, wst = mls_quantize(wt, fmt, kb, r_u8=rw, grouping=grouping)
    cpu = (xc, xsg, xst, wc.t(), wsgT.t(), wst)
    dx = xc.t().contiguous().to(cuda).t() if layout == "xT" else xc.to(cuda)
    dw = wc.t().contiguous().to(cuda) if layout == "nmajor" else wc.to(cuda).t()
    card = (dx, xsg.to(cuda), xst.to(cuda), dw, wsgT.to(cuda).t(), wst.to(cuda))
    return cpu, card


def _plan_of(variant, m, n, fmt):
    """``variant`` on the format's body: the walk and the split at the
    narrowest tile width that holds n, the wgmma variant at its 128."""
    body = "int32" if fmt.max_fraction > 127 else "int8"
    bn = WGMMA_BN if variant == "wgmma" else 16 if n <= 16 else 32 if n <= 32 else 64
    return MatmulPlan(variant, body, bn, 0)


@pytest.mark.parametrize("variant", ["walk", "split", "wgmma"])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("fmt,case", PLAN_PARAMS, ids=str)
def test_matmul_plans_match_plain(cuda, fmt, case, grouping, variant):
    """Every K3 variant that _checked_plan accepts on the body the format
    takes, for ragged tiles, k_blocks on and off the 16-wide k step
    (cp.async or plain staging) and of 128 and 256 (the wgmma variant's),
    and operands with either stride order; a variant it refuses (wgmma at a
    k_block off 128 or on the int32 body) raises on the card as well:
    nothing falls back."""
    m, k, n, kb, layout = case
    fmt = EMFormat(*fmt)
    cpu, card = _codes_on(cuda, fmt, grouping, m, k, n, kb, layout)
    assert (card[0].stride(1) == 1) == (layout != "xT")
    assert (card[3].stride(0) == 1) == (layout != "nmajor")
    auto = matmul_plan(m, n, k, kb, fmt)
    assert auto.body == ("int32" if fmt.max_fraction > 127 else "int8")
    plan = _plan_of(variant, m, n, fmt)
    want = mls_matmul(*cpu, fmt, kb, grouping)
    try:
        _checked_plan(plan, m, n, k, kb, fmt)
    except ValueError:
        assert variant == "wgmma" and (kb % 128 or fmt.max_fraction > 127)
        with pytest.raises(ValueError):
            mls_matmul(*card, fmt, kb, grouping, plan=plan)
        return
    got = mls_matmul(*card, fmt, kb, grouping, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


# the wgmma variant's own cases (M, K, N, k_block, layout): ragged M and N
# (200 x 1024 x 136: two row tiles, the second of 72 rows, two column tiles,
# the second of 8), the weight as the strided transposed view of a
# K-contiguous tensor and as an N-contiguous one, x M-contiguous, k_block 256
WGMMA_CASES = [(200, 1024, 136, 128, "kmajor"), (256, 768, 384, 256, "kmajor"),
               (130, 512, 260, 128, "nmajor"), (384, 1024, 200, 256, "xT")]


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("fmt", [(2, 4), (2, 1), (0, 4)])
@pytest.mark.parametrize("case", WGMMA_CASES, ids=str)
def test_wgmma_matches_plain(cuda, case, fmt, grouping):
    """K3's wgmma variant against mls_matmul_ref bit for bit, one launch
    counted and recorded with its plan, for all four groupings and the
    three int8 formats."""
    from repro_torch.kernels.ref import mls_matmul_ref

    m, k, n, kb, layout = case
    fmt = EMFormat(*fmt)
    cpu, card = _codes_on(cuda, fmt, grouping, m, k, n, kb, layout)
    plan = MatmulPlan("wgmma", "int8", WGMMA_BN, 0)
    reset_launch_counts()
    got = mls_matmul(*card, fmt, kb, grouping, plan=plan)
    torch.cuda.synchronize()
    assert launch_counts()["mls_matmul"] == 1
    assert ("mls_matmul", "cuda", m, n, k, kb, grouping, fmt,
            _checked_plan(plan, m, n, k, kb, fmt)) in launch.RECORDED
    want = mls_matmul_ref(*cpu, fmt, kb)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got.cpu(), mls_matmul(*cpu, fmt, kb, grouping))


@pytest.mark.parametrize("which", ["x", "w"])
def test_wgmma_all_zero_operand(cuda, which):
    fmt = EMFormat(2, 4)
    cpu, card = _codes_on(cuda, fmt, "nc", 256, 512, 256, 128, "kmajor")
    i = 0 if which == "x" else 3
    cpu = tuple(torch.zeros_like(t) if j == i else t for j, t in enumerate(cpu))
    card = tuple(torch.zeros_like(t) if j == i else t for j, t in enumerate(card))
    got = mls_matmul(*card, fmt, 128, "nc", plan=MatmulPlan("wgmma", "int8", WGMMA_BN, 0))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), mls_matmul(*cpu, fmt, 128, "nc"))
    assert not got.any() and not torch.signbit(got).any()


@pytest.mark.parametrize("bn", [16, 32, 64])
def test_matmul_tile_width_does_not_change_the_bits(cuda, bn):
    fmt = EMFormat(2, 4)
    cpu, card = _codes_on(cuda, fmt, "nc", 37, 256, 70, 128, "kmajor")
    want = mls_matmul(*cpu, fmt, 128, "nc")
    for variant in ("walk", "split"):
        got = mls_matmul(*card, fmt, 128, "nc", plan=MatmulPlan(variant, "int8", bn, 0))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), variant


# (M, K, k_block, values): widths off the float4 access (9), two float4 slots
# per lane (144), a wide group read by a block without vector access (2050),
# all zeros (s_t = 1), -0.0 entries, and a tensor max over more chunks than
# pass A has blocks
EDGE_CASES = [(6, 45, 9, "normal"), (10, 288, 144, "normal"), (3, 2050, 2050, "normal"),
              (16, 256, 128, "zeros"), (16, 256, 128, "neg_zeros"),
              (300, 4096, 128, "normal")]


@pytest.mark.parametrize("fmt", [(2, 4), (2, 1)])
@pytest.mark.parametrize("grouping", ["nc", "n"])
@pytest.mark.parametrize("case", EDGE_CASES, ids=str)
def test_quantize_two_passes_match_plain(cuda, case, grouping, fmt):
    m, k, kb, values = case
    x, r = _operand(8, m, k)
    if values == "zeros":
        x = torch.zeros_like(x)
    elif values == "neg_zeros":
        x[::2] = -0.0
        x[1, :] = -0.0  # a row of -0.0 only
    want = mls_quantize(x, EMFormat(*fmt), kb, r_u8=r, grouping=grouping)
    got = mls_quantize(x.to(cuda), EMFormat(*fmt), kb, r_u8=r.to(cuda), grouping=grouping)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    if values == "zeros":
        assert float(got[2]) == 1.0


@pytest.mark.parametrize("case", [(2, 5, 9, 7, 3, (1, 1), "SAME"),
                                  (2, 4, 8, 6, 3, (2, 2), "SAME"),
                                  (1, 3, 8, 4, 1, (2, 2), "SAME")])
def test_conv_on_the_card_matches_cpu(cuda, case):
    n, c, hw, o, k, stride, pad = case
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((n, c, hw, hw)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((o, c, k, k)) * 0.2).astype(np.float32))
    cfg = QuantConfig(fmt=EMFormat(2, 4), k_block=32, stochastic=False)
    out = {}
    for dev in ("cpu", "cuda"):
        xd = x.to(dev).detach().requires_grad_()
        wd = w.to(dev).detach().requires_grad_()
        y = lowbit_conv_fused(xd, wd, None, stride, pad, cfg)
        g = torch.linspace(-1, 1, y.numel()).reshape(y.shape).to(dev)
        (y * g).sum().backward()
        out[dev] = [t.detach().cpu() for t in (y, xd.grad, wd.grad)]
    for a, b in zip(out["cpu"], out["cuda"]):
        assert torch.equal(a, b)


def test_conv_counts_six_quantize_and_three_gemm_launches(cuda):
    x = torch.randn(2, 4, 8, 8, device=cuda, requires_grad=True)
    w = torch.randn(6, 4, 3, 3, device=cuda, requires_grad=True)
    cfg = QuantConfig(fmt=EMFormat(2, 4), k_block=32, stochastic=True)
    reset_launch_counts()
    lowbit_conv_fused(x, w, 5, (1, 1), "SAME", cfg).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts() == {"mls_quantize_rows": 6, "mls_quantize_rows_amax": 0,
                               "mls_quantize_rows_codes": 0, "mls_quantize_given_sg": 0,
                               "mls_matmul": 3, "implicit_conv": 0, "conv_tensor_scale": 0,
                               "sabotage_overlap": 0}


# (x shape, w shape, stride, padding, k_block)
IMPLICIT_CASES = [
    ((2, 5, 9, 9), (70, 5, 3, 3), (1, 1), "SAME", 9),
    ((3, 8, 12, 12), (6, 8, 3, 3), (2, 2), "VALID", 36),
    ((2, 4, 8, 8), (6, 4, 3, 3), (2, 2), "SAME", 18),
    ((1, 3, 8, 8), (4, 3, 1, 1), (2, 2), "SAME", 3),
]


@pytest.mark.parametrize("fmt", [(2, 4), (2, 1), (0, 4)])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case", IMPLICIT_CASES, ids=["ragged", "valid", "s2", "1x1"])
def test_implicit_conv_kernel_matches_plain(cuda, case, grouping, fmt):
    xs, ws, stride, pad, kb = case
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(ws) * 0.2).astype(np.float32))
    oh = ow = (xs[2] - 1) // stride[0] + 1 if pad == "SAME" else (xs[2] - ws[2]) // stride[0] + 1
    k0 = xs[1] * ws[2] * ws[3]
    r_x = torch.from_numpy(rng.integers(0, 256, (xs[0] * oh * ow, k0), dtype=np.uint8))
    r_w = torch.from_numpy(rng.integers(0, 256, (ws[0], k0), dtype=np.uint8))
    kw = dict(fmt=EMFormat(*fmt), k_block=kb, grouping=grouping)
    want = implicit_conv_forward(x, w, r_x, r_w, stride, pad, **kw)
    before = launch_counts()["implicit_conv"]
    got = implicit_conv_forward(x.to(cuda), w.to(cuda), r_x.to(cuda), r_w.to(cuda), stride,
                                pad, **kw)
    torch.cuda.synchronize()
    assert launch_counts()["implicit_conv"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("grouping,stochastic", [("nc", True), ("c", True), ("n", True),
                                                 ("none", True), ("none", False)])
def test_implicit_conv_on_the_card_equals_im2col(cuda, grouping, stochastic):
    """Forward and both gradients; grouping "none" with nearest rounding
    takes the code-reuse weight gradient."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 8, 10, 10)).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.standard_normal((12, 8, 3, 3)) * 0.2).astype(np.float32)).to(cuda)
    out = {}
    for impl in ("im2col", "implicit"):
        cfg = QuantConfig(fmt=EMFormat(2, 4), k_block=36, grouping=grouping,
                          stochastic=stochastic, conv_impl=impl)
        xd, wd = x.detach().requires_grad_(), w.detach().requires_grad_()
        y = lowbit_conv_fused(xd, wd, 9, (2, 2), "SAME", cfg)
        g = torch.linspace(-1, 1, y.numel(), device=cuda).reshape(y.shape)
        (y * g).sum().backward()
        out[impl] = [t.detach().cpu() for t in (y, xd.grad, wd.grad)]
    for a, b in zip(out["im2col"], out["implicit"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("grouping,stochastic,want", [
    ("nc", True, {"mls_quantize_rows": 5, "mls_quantize_given_sg": 0, "mls_matmul": 2,
                  "conv_tensor_scale": 0}),
    ("none", False, {"mls_quantize_rows": 0, "mls_quantize_given_sg": 5, "mls_matmul": 2,
                     "conv_tensor_scale": 1}),
])
def test_implicit_conv_launch_counts(cuda, grouping, stochastic, want):
    """Forward: K4 and the weight's quantizer.  Backward: two GEMMs of
    two quantizes each, or with code reuse ("none", nearest) K4's tensor
    scale pass, one code pass, the error's quantizer and the GEMM for the
    weight gradient."""
    x = torch.randn(2, 4, 8, 8, device=cuda, requires_grad=True)
    w = torch.randn(6, 4, 3, 3, device=cuda, requires_grad=True)
    cfg = QuantConfig(fmt=EMFormat(2, 4), k_block=36, grouping=grouping, stochastic=stochastic)
    reset_launch_counts()
    lowbit_conv_fused(x, w, 5, (1, 1), "SAME", cfg).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts() == {**want, "implicit_conv": 1, "sabotage_overlap": 0,
                               "mls_quantize_rows_amax": 0, "mls_quantize_rows_codes": 0}


@pytest.mark.parametrize("seed", [0, 1])
def test_sabotage_overlap_kernel_matches_plain(cuda, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((8, 16)).astype(np.float32)).to(cuda)
    w = torch.from_numpy(rng.standard_normal((16, 32)).astype(np.float32)).to(cuda)
    probe = torch.zeros((8, 32), dtype=torch.int32, device=cuda)
    before = launch_counts()["sabotage_overlap"]
    out = sabotage_overlap_matmul(x, w, probe)
    torch.cuda.synchronize()
    assert launch_counts()["sabotage_overlap"] == before + 1
    tiles = sabotage_overlap_tiles(x, w)
    writers = writers_per_block(k5_spec(8, 16, 32, "cuda"), "outputs[0]")[0].tolist()
    assert writers == [2, 0, 2, 0]
    for c in range(4):
        block, stores = out[:, 8 * c : 8 * c + 8], probe[:, 8 * c : 8 * c + 8]
        assert (stores == writers[c]).all()
        if writers[c] == 0:
            assert torch.isnan(block).all()
            continue
        bits = block.view(torch.int32)
        either = (bits == tiles[(0, c)].view(torch.int32)) | \
            (bits == tiles[(0, c + 1)].view(torch.int32))
        assert either.all()


@pytest.mark.parametrize("module,query", [
    ("mls_quantize", "mls_quantize_constants"), ("mls_matmul", "mls_matmul_constants"),
    ("implicit_conv", "implicit_conv_constants"), ("sabotage", "sabotage_overlap_constants")])
def test_library_tile_constants_equal_the_descriptors(cuda, module, query):
    tile = importlib.import_module(f"repro_torch.kernels.{module}").TILE
    assert launch.tile_constants(query, tile, "cuda") == tile


_K1_K3 = {"quantize_amax", "quantize_groups_warp", "mls_matmul_walk", "mls_matmul_terms",
          "mls_matmul_sum"}


@pytest.mark.parametrize("k_block,kernels", [
    (128, _K1_K3),
    (144, _K1_K3 | {"conv_amax", "implicit_conv"})])
def test_full_width_step_launch_specs_verify_clean(cuda, k_block, kernels):
    """With no tile cache the step launches ``kernels``; with the seed
    cache (on its card) it may take K1's block pass and K3's wgmma variant
    too (the seed picks it at several ResNet-20 GEMMs); every launch
    verifies either way."""
    from repro_torch.kernels import autotune

    for cache in (autotune.TuneCache(), autotune.get_cache()):
        with autotune.override_cache(cache):
            graph = cifar_train_graph(k_block, device=cuda)
            cov, records = graph.run()
        specs = recorded_specs(records)
        if cache.device is None:
            assert {s.kernel for s, _ in specs} == kernels
        else:
            assert {s.kernel for s, _ in specs} <= kernels | {
                "quantize_groups_block", "mls_matmul_decode", "mls_matmul_wgmma"}
        assert {key[1] for key in records} == {"cuda"}  # recorded on the card
        report = verify_specs(graph.name, specs)
        assert report.ok, report.violations
        assert report.max_integer_bits == (21 if k_block == 128 else 22)
    assert cov.quantized_fraction >= 0.99


# ---------------------------------------------------------------------------
# K2 with its scales made on the card, K4 with its staged band
# ---------------------------------------------------------------------------
def _device_kernels(fn) -> set[str]:
    """Names of the device kernels ``fn`` launches (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


_K2_KERNELS = ("quantize_cols_amax", "quantize_cols_reduce", "quantize_scales",
               "quantize_codes", "quantize_amax")
_K1_KERNELS = ("quantize_amax", "quantize_groups_warp", "quantize_groups_block")
_K4_KERNELS = ("conv_amax", "implicit_conv_kernel", "conv_win_amax", "conv_chan_amax",
               "conv_group_reduce", "conv_chan_scales")


def _only(names: set[str], allowed) -> bool:
    return bool(names) and all(any(a in n for a in allowed) for n in names)


# (M, K, k_block, values): the path's operands -- tall (2 groups), wide (1024
# groups), the implicit "none" path's (N*C*Hp, Wp) code operand -- an all-zero
# operand, widths and k_blocks off 4 (scalar columns), many row slices
K2_CASES = [(131072, 256, 128, "normal"), (144, 131072, 128, "normal"),
            (69632, 34, 34, "normal"), (4096, 256, 128, "zeros"), (37, 90, 30, "normal"),
            (6, 45, 9, "normal"), (3000, 384, 128, "normal")]


@pytest.mark.parametrize("fmt", [(2, 4), (2, 1)])
@pytest.mark.parametrize("grouping", ["c", "none"])
@pytest.mark.parametrize("case", K2_CASES, ids=str)
def test_k2_matches_plain(cuda, case, grouping, fmt):
    m, k, kb, values = case
    x, r = _operand(9, m, k)
    if values == "zeros":
        x = torch.zeros_like(x)
    big = m * k > 1 << 22  # the plain version on the card, as chip_smoke.py
    xd, rd = x.to(cuda), r.to(cuda)
    want = mls_quantize(xd if big else x, EMFormat(*fmt), kb,
                        r_u8=rd if big else r, grouping=grouping)
    before = launch_counts()["mls_quantize_given_sg"]
    got = mls_quantize(xd, EMFormat(*fmt), kb, r_u8=rd, grouping=grouping)
    torch.cuda.synchronize()
    assert launch_counts()["mls_quantize_given_sg"] == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b.cpu())
    if values == "zeros":
        assert float(got[2]) == 1.0


@pytest.mark.parametrize("grouping", ["c", "none"])
def test_k2_keeps_nan_like_the_plain_version(cuda, grouping):
    """A NaN makes the tensor scale 1 and its group's scale the one the
    plain version (on the CPU) derives from the NaN; every code but the
    NaN's own, which IEEE leaves to the implementation, is bit-identical."""
    x, r = _operand(10, 40, 96)
    x[7, 40] = float("nan")
    want = mls_quantize(x, EMFormat(2, 4), 32, r_u8=r, grouping=grouping)
    got = [t.cpu() for t in mls_quantize(x.to(cuda), EMFormat(2, 4), 32, r_u8=r.to(cuda),
                                         grouping=grouping)]
    assert float(got[2]) == float(want[2]) == 1.0
    assert torch.equal(got[1], want[1])
    keep = ~torch.isnan(x)
    assert torch.equal(got[0][keep], want[0][keep])


@pytest.mark.parametrize("variant", ["warp", "block"])
@pytest.mark.parametrize("grouping", ["nc", "n"])
@pytest.mark.parametrize("shape", [(37, 256), (300, 4096), (5, 2048)])
def test_k1_split_entries_match_the_one_call_entry_and_plain(cuda, shape, grouping, variant):
    """K1's two split entries (pass A, then pass B over the given max; the
    tensor-parallel path) with the operand's own max give the one-call
    entry's bits and the plain version's; with a larger given max (another
    rank's), ``quantize_ref`` with that max.  One launch of each entry, none
    of the one-call entry."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.mls_quantize import quantize_rows_split
    from repro_torch.kernels.ref import quantize_ref

    x, r = _operand(3, *shape)
    width = 128 if grouping == "nc" else shape[1]
    if variant == "warp" and width > 1024:
        pytest.skip("a warp takes groups of at most 1024")
    config = autotune.BlockConfig(variant=variant, amax_blocks=3)
    xd, rd = x.to(cuda), r.to(cuda)
    one = [t.cpu() for t in mls_quantize(xd, EMFormat(2, 4), 128, r_u8=rd, grouping=grouping,
                                         config=config)]
    reset_launch_counts()
    split = [t.cpu() for t in quantize_rows_split(xd, EMFormat(2, 4), 128, r_u8=rd,
                                                  grouping=grouping, config=config)]
    assert {k: launch_counts()[k] for k in ("mls_quantize_rows", "mls_quantize_rows_amax",
                                             "mls_quantize_rows_codes")} == {
        "mls_quantize_rows": 0, "mls_quantize_rows_amax": 1, "mls_quantize_rows_codes": 1}
    plain = quantize_ref(x, EMFormat(2, 4), 128, r_u8=r, grouping=grouping)
    for a, b, c in zip(split, one, plain):
        assert torch.equal(a, b) and torch.equal(a, c)
    big = x.abs().amax() * 3.0
    got = [t.cpu() for t in quantize_rows_split(
        xd, EMFormat(2, 4), 128, r_u8=rd, grouping=grouping, config=config,
        reduce_amax=lambda a: torch.full_like(a, float(big)))]
    want = quantize_ref(x, EMFormat(2, 4), 128, r_u8=r, grouping=grouping, amax=big)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_k1_split_entries_on_a_multi_piece_shard_match_plain(cuda, arch):
    """K1's split entries on one rank's in_proj error at a model axis of 2
    (its z and x pieces and, on rank 0, the tail whose dt ends in a ragged
    group), padded as qd_gemm pads it, with the rounding bytes of the
    unsharded operand's pieces and the unsharded operand's max: the codes
    and group scales are the pieces of the unsharded operand's (the plain
    version of the whole), and the plain version of the pieces agrees."""
    from repro_torch.configs import get_config
    from repro_torch.core.lowbit import Sharded
    from repro_torch.launch.specs import abstract_params
    from repro_torch.kernels.mls_quantize import quantize_rows_split
    from repro_torch.kernels.ref import quantize_ref
    from repro_torch.parallel.tensor import tp_layout

    cfg = get_config(arch)
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    sp = tp_layout(cfg, shapes, 2)["layers.0.in_proj.w"]
    n = sp.full
    x, r = _operand(12, 48, n + (-n) % 128)
    x[:, n:] = 0.0  # the unsharded operand's padding
    want = quantize_ref(x, EMFormat(2, 4), 128, r_u8=r, grouping="nc")
    for rank in range(2):
        shard = Sharded(1, sp.pieces[rank], n).padded(x.shape[1])
        size = sum(b - a for a, b in shard.spans(sp.size(rank) + (-sp.size(rank)) % 128))
        xs, rs = shard.take(x, size).contiguous(), shard.take(r, size).contiguous()
        amax = lambda a: torch.full_like(a, float(x.abs().amax()))  # noqa: E731
        reset_launch_counts()
        got = [t.cpu() for t in quantize_rows_split(xs.to(cuda), EMFormat(2, 4), 128,
                                                    r_u8=rs.to(cuda), reduce_amax=amax)]
        assert launch_counts()["mls_quantize_rows_amax"] == 1
        assert launch_counts()["mls_quantize_rows_codes"] == 1
        plain = quantize_rows_split(xs, EMFormat(2, 4), 128, r_u8=rs, reduce_amax=amax)
        gpieces = Sharded(1, tuple((a // 128, b // 128) for a, b in shard.spans(size)),
                          want[1].shape[1])
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
        assert torch.equal(got[0], shard.take(want[0], size))
        assert torch.equal(got[1], gpieces.take(want[1], size // 128))
        assert float(got[2]) == float(want[2])


@pytest.mark.parametrize("grouping", ["nc", "n"])
def test_k1_keeps_nan_like_the_plain_version(cuda, grouping):
    """K1's group scale of a NaN max is made through mls::scale_ratio, so
    the NaN's group gets the scale the plain version (on the CPU) derives
    from the NaN's payload; the tensor scale is 1 and every code but the
    NaN's own is bit-identical."""
    x, r = _operand(10, 40, 96)
    x[7, 40] = float("nan")
    want = mls_quantize(x, EMFormat(2, 4), 32, r_u8=r, grouping=grouping)
    before = launch_counts()["mls_quantize_rows"]
    got = [t.cpu() for t in mls_quantize(x.to(cuda), EMFormat(2, 4), 32, r_u8=r.to(cuda),
                                         grouping=grouping)]
    assert launch_counts()["mls_quantize_rows"] == before + 1
    assert float(got[2]) == float(want[2]) == 1.0
    assert torch.equal(got[1], want[1])
    keep = ~torch.isnan(x)
    assert torch.equal(got[0][keep], want[0][keep])


@pytest.mark.parametrize("grouping", ["c", "none"])
def test_k2_launches_only_its_own_kernels(cuda, grouping):
    """On the card, mls_quantize for "c" / "none" is one C call: no
    PyTorch kernel (abs, amax, where, the scale math) around K2's own."""
    x, r = _operand(11, 512, 256)
    x, r = x.to(cuda), r.to(cuda)
    names = _device_kernels(lambda: mls_quantize(x, EMFormat(2, 4), 128, r_u8=r,
                                                 grouping=grouping))
    assert _only(names, _K2_KERNELS), names


# full-width ResNet-20's stage convs at batch 4, k_block 144; and small
# convs with an int32-body format (<3,1>: fractions up to 192)
STAGE_CONVS = [((4, 16, 32, 32), (16, 16, 3, 3), (1, 1), "SAME", 144),
               ((4, 16, 32, 32), (32, 16, 3, 3), (2, 2), "SAME", 144),
               ((4, 64, 8, 8), (64, 64, 3, 3), (1, 1), "SAME", 144)]
INT32_CONVS = [((2, 8, 10, 10), (12, 8, 3, 3), (1, 1), "SAME", 72),
               ((3, 8, 12, 12), (70, 8, 3, 3), (2, 2), "VALID", 36)]
# 1x1 convs of the zoo that the dispatch sends to K4 at k_block 128, at
# batch 2: ResNet-18's stride-2 projection of stage 3 (a stride wider than
# the window: pass A must skip the rows and columns no patch covers) and
# GoogleNet's 3b branch on a 256-channel input
ZOO_CONVS = [((2, 128, 28, 28), (256, 128, 1, 1), (2, 2), "SAME", 128),
             ((2, 256, 32, 32), (128, 256, 1, 1), (1, 1), "SAME", 128)]


def _conv_inputs(seed, xs, ws, stride, pad):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal(xs).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal(ws) * 0.2).astype(np.float32))
    from repro_torch.kernels import conv_geometry

    geom = conv_geometry(xs, ws, stride, pad)
    r_x = torch.from_numpy(rng.integers(0, 256, (geom.m0, geom.k0), dtype=np.uint8))
    r_w = torch.from_numpy(rng.integers(0, 256, (geom.o, geom.k0), dtype=np.uint8))
    return x, w, r_x, r_w, geom


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case,fmt", [(c, (2, 4)) for c in STAGE_CONVS]
                         + [(c, (2, 1)) for c in STAGE_CONVS[:1]]
                         + [(c, (3, 1)) for c in INT32_CONVS]
                         + [(c, (2, 4)) for c in ZOO_CONVS],
                         ids=["stage1", "stage2_s2", "stage3", "stage1_e2m1", "int32_ragged",
                              "int32_valid_two_n_tiles", "resnet18_proj_s2", "googlenet_3b_1x1"])
def test_k4_matches_plain_at_the_stage_convs(cuda, case, fmt, grouping):
    xs, ws, stride, pad, kb = case
    x, w, r_x, r_w, _ = _conv_inputs(12, xs, ws, stride, pad)
    kw = dict(fmt=EMFormat(*fmt), k_block=kb, grouping=grouping)
    want = implicit_conv_forward(x, w, r_x, r_w, stride, pad, **kw)
    got = implicit_conv_forward(x.to(cuda), w.to(cuda), r_x.to(cuda), r_w.to(cuda), stride,
                                pad, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("grouping", GROUPINGS)
def test_k4_keeps_nan_like_the_plain_version(cuda, grouping):
    """A NaN pixel: K4 makes every grouping's scales itself, passing a NaN
    group max to the group scale undivided (mls::scale_ratio), so every
    output row whose patch does not cover the pixel is bit-identical to the
    plain version on the CPU."""
    x, w, r_x, r_w, geom = _conv_inputs(13, (2, 4, 8, 8), (6, 4, 3, 3), (1, 1), "SAME")
    x[1, 2, 3, 5] = float("nan")
    kw = dict(fmt=EMFormat(2, 4), k_block=18, grouping=grouping)
    want = implicit_conv_forward(x, w, r_x, r_w, (1, 1), "SAME", **kw)
    got = implicit_conv_forward(x.to(cuda), w.to(cuda), r_x.to(cuda), r_w.to(cuda), (1, 1),
                                "SAME", **kw).cpu()
    hit = torch.zeros((2, 8, 8), dtype=torch.bool)
    hit[1, 2:5, 4:7] = True  # the outputs whose 3x3 patch covers (3, 5)
    keep = ~hit[:, None].expand_as(got)
    assert torch.equal(got[keep], want[keep])


@pytest.mark.parametrize("grouping,allowed", [
    ("nc", _K4_KERNELS + _K1_KERNELS),
    ("none", _K4_KERNELS + _K2_KERNELS),
    ("c", _K4_KERNELS + _K2_KERNELS),
    ("n", _K4_KERNELS + _K1_KERNELS)])
def test_implicit_conv_launches_only_k4_and_the_weight_quantizer(cuda, grouping, allowed):
    """implicit_conv_forward on the card, every grouping: no F.pad, abs,
    max_pool2d or amax; K4's own kernels and the weight's quantizer only."""
    x, w, r_x, r_w, _ = _conv_inputs(14, (4, 16, 16, 16), (16, 16, 3, 3), (1, 1), "SAME")
    args = (x.to(cuda), w.to(cuda), r_x.to(cuda), r_w.to(cuda), (1, 1), "SAME")
    names = _device_kernels(lambda: implicit_conv_forward(
        *args, fmt=EMFormat(2, 4), k_block=144, grouping=grouping))
    assert _only(names, allowed), names
    assert any("implicit_conv_kernel" in n for n in names)


def test_covered_tensor_scale_on_the_card(cuda):
    """K4's pass A alone: the covered abs-max of a VALID stride-2 conv
    whose tail no patch covers, bit-identical to the plain version."""
    from repro_torch.kernels import conv_geometry
    from repro_torch.kernels.implicit_conv import covered_tensor_scale

    x, _, _, _, _ = _conv_inputs(15, (3, 8, 12, 12), (6, 8, 3, 3), (2, 2), "VALID")
    x[:, :, -1, :] = 9.0  # the uncovered last row
    geom = conv_geometry(x.shape, (6, 8, 3, 3), (2, 2), "VALID")
    want, _ = covered_tensor_scale(x, geom)
    before = launch_counts()["conv_tensor_scale"]
    got, xp = covered_tensor_scale(x.to(cuda), geom)
    torch.cuda.synchronize()
    assert launch_counts()["conv_tensor_scale"] == before + 1
    assert float(got) == float(want) < 9.0
    assert xp.shape == (3, 8, 12, 12)


# ---------------------------------------------------------------------------
# The fake-quant backend and the zoo on the card
# ---------------------------------------------------------------------------
def _step(model, x, y, qcfg):
    logits = model(x, qcfg, None)
    loss = torch.nn.functional.cross_entropy(logits, y)
    loss.backward()
    return (float(loss.detach()), logits.detach().cpu(),
            {n: p.grad.detach().cpu() for n, p in model.named_parameters()})


def test_fake_quant_step_on_the_card_agrees_with_cpu(cuda):
    """ResNet-20 on the fake-quant backend, nearest rounding: the card's
    step (cuDNN fp32 convs on the fake-quantized operands) against the
    CPU's, to the limits of chip_smoke.py's agree phase (loss 1e-5
    relative, logits 1e-5, gradient cosine >= 1 - 1e-5 and relative error
    <= 1e-4): the quantizer is the same PyTorch code on both devices, the
    convs and BN sum in other orders.  No kernel of the port launches."""
    from repro_torch.models.cnn import CNNConfig, init_cnn

    cfg = CNNConfig("resnet20", width_mult=0.25, in_hw=8)
    qcfg = QuantConfig(fmt=EMFormat(2, 1), k_block=32, stochastic=False, backend="fake_quant")
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn((4, 3, 8, 8), generator=gen), torch.randint(0, 10, (4,), generator=gen)
    out = {}
    reset_launch_counts()
    for dev in ("cpu", "cuda"):
        out[dev] = _step(init_cnn(cfg, 3, dev), x.to(dev), y.to(dev), qcfg)
    assert not any(launch_counts().values())
    (l_c, z_c, g_c), (l_g, z_g, g_g) = out["cpu"], out["cuda"]
    assert abs(l_g - l_c) <= 1e-5 * abs(l_c)
    assert float((z_g - z_c).abs().max()) <= 1e-5
    for n in g_c:
        a, b = g_g[n].flatten().double(), g_c[n].flatten().double()
        assert float(a @ b / (a.norm() * b.norm())) >= 1 - 1e-5, n
        assert float((a - b).norm() / b.norm()) <= 1e-4, n


def _chip_smoke():
    """``chip_smoke.py`` at the repo root, whose ``expected_launches`` is
    the count of a step's launches by the conv dispatch."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch,hw", [("vgg16", 32), ("googlenet", 32), ("resnet18", 64),
                                     ("resnet34", 64)])
def test_zoo_step_on_the_card_launches_what_the_dispatch_gives(cuda, arch, hw):
    """One quantized-backend step of each zoo model at a small width on the
    card: a finite loss, and per C entry point the launches that
    chip_smoke.expected_launches gives over the model's traced quantized
    convs."""
    from repro_torch.models.cnn import CNNConfig, init_cnn, quantized_convs

    cfg = CNNConfig(arch, width_mult=0.25, in_hw=hw)
    qcfg = QuantConfig(fmt=EMFormat(2, 4), k_block=32)
    want = _chip_smoke().expected_launches(qcfg, quantized_convs(cfg, 4))
    gen = torch.Generator().manual_seed(2)
    x, y = torch.randn((4, 3, hw, hw), generator=gen), torch.randint(0, 10, (4,), generator=gen)
    model = init_cnn(cfg, 0, cuda)
    reset_launch_counts()
    loss, _, _ = _step(model, x.to(cuda), y.to(cuda), qcfg)
    torch.cuda.synchronize()
    assert np.isfinite(loss)
    assert launch_counts() == want


# (M, K real, K padded to 128, N) of zoo GEMMs at full width: ResNet-34's
# stage-4 3x3 at 224x224, batch 64 (forward, weight and data gradients),
# GoogleNet's 4b 3x3 forward at 32x32, batch 128, and ResNet-18's stage-1
# weight gradient (1568 scaling groups)
ZOO_GEMMS = [(3136, 4608, 4608, 512), (4608, 3136, 3200, 512), (3136, 512, 512, 4608),
             (32768, 1008, 1024, 224), (576, 200704, 200704, 64)]


@pytest.mark.parametrize("grouping", ["nc", "n"])
@pytest.mark.parametrize("mkn", ZOO_GEMMS, ids=str)
def test_k1_k3_match_plain_at_zoo_shapes(cuda, mkn, grouping):
    """K1 on both operands of a zoo GEMM and K3 on their codes, on the plan
    matmul_plan picks and on every other variant _checked_plan accepts,
    bit-identical to quantize_ref and mls_matmul_ref (<2,4>, k_block
    128)."""
    from repro_torch.kernels import rounding_bytes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    M, real, K, N = mkn
    fmt, gen = EMFormat(2, 4), torch.Generator(device=cuda).manual_seed(M + N)
    qs = []
    for rows in (M, N):
        x = torch.zeros((rows, K), device=cuda)
        x[:, :real] = torch.randn((rows, real), generator=gen, device=cuda)
        r = rounding_bytes(x.shape, gen, cuda)
        got = mls_quantize(x, fmt, 128, r_u8=r, grouping=grouping)
        want = quantize_ref(x, fmt, 128, r_u8=r, grouping=grouping)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        qs.append(got)
    (xc, xsg, xst), (wc, wsg, wst) = qs
    args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, 128)
    want = mls_matmul_ref(*args)
    for p in _chip_smoke().k3_plans(M, N, K, 128, fmt):
        assert torch.equal(mls_matmul(*args, grouping, plan=p), want), p


# (M, K, N) of the LM serving path's GEMMs at full width: chatglm3-6b's
# decode (batch 4) wq, wk/wv, w_up and w_down and its prefill w_up (batch
# 4 x 128 tokens), mamba2-370m's in_proj at prefill, zamba2-7b's decode
# out_proj (56 scaling groups); moonshot-v1-16b-a3b's decode attention,
# llama4-scout's shared expert at decode (w_up, w_down), seamless-m4t's
# decoder MLP at decode and its encoder's w_up at prefill (4 x 1024 frames)
LM_GEMMS = [(4, 4096, 4096), (4, 4096, 256), (4, 4096, 13696), (4, 13696, 4096),
            (512, 4096, 13696), (512, 1024, 4384), (4, 7168, 3584),
            (4, 2048, 2048), (4, 5120, 8192), (4, 8192, 5120), (4, 1024, 4096),
            (4, 4096, 1024), (4096, 1024, 4096)]


@pytest.mark.parametrize("mkn", LM_GEMMS, ids=str)
def test_k1_k3_match_plain_at_lm_shapes(cuda, mkn):
    """The serving path's quantized linear: K1 ("nc", nearest rounding) on
    the input and on the transposed weight, K3 on their codes on the plan
    matmul_plan picks and on every other variant _checked_plan accepts,
    bit-identical to quantize_ref and mls_matmul_ref (<2,4>, k_block
    128)."""
    from repro_torch.kernels import rounding_bytes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    M, K, N = mkn
    fmt, gen = EMFormat(2, 4), torch.Generator(device=cuda).manual_seed(M + N)
    qs = []
    for rows, scale in ((M, 1.0), (N, 0.02)):
        x = torch.randn((rows, K), generator=gen, device=cuda) * scale
        r = rounding_bytes(x.shape, None, cuda)  # the serving path's nearest rounding
        got = mls_quantize(x, fmt, 128, r_u8=r, grouping="nc")
        want = quantize_ref(x, fmt, 128, r_u8=r, grouping="nc")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        qs.append(got)
    (xc, xsg, xst), (wc, wsg, wst) = qs
    args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, 128)
    want = mls_matmul_ref(*args)
    for p in _chip_smoke().k3_plans(M, N, K, 128, fmt):
        assert torch.equal(mls_matmul(*args, "nc", plan=p), want), p


LM_ARCHS = ["chatglm3-6b", "mamba2-370m", "zamba2-7b", "moonshot-v1-16b-a3b",
            "llama4-scout-17b-a16e", "seamless-m4t-medium"]


def _lm_inputs(cfg, toks) -> dict:
    """The batch of ``toks``, with the encoder-decoder's source frames."""
    batch = {"tokens": toks}
    if cfg.family == "encdec":
        batch["src_emb"] = torch.randn((toks.shape[0], 12, cfg.frontend_dim),
                                       generator=torch.Generator().manual_seed(5))
    return batch


@pytest.mark.parametrize("name", LM_ARCHS)
def test_smoke_serve_on_the_card_agrees_with_the_cpu(cuda, name):
    """A smoke config on the quantized kernels, the same weights on the card
    and on the CPU: prefill and decode logits within 1e-3 of max(1,
    max|logit|) (the norms and attention sum in other orders; the quantized
    linears are bit-exact), the same greedy tokens, and the launches of
    chip_smoke.serve_linears's closed form on the card (K1 twice and K3
    once per quantized linear; the encoder-decoder's prefill also runs its
    encoder)."""
    import copy
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import ServeEngine

    cfg = dataclasses.replace(get_smoke_config(name), quant_backend="pallas")
    cpu_model = init_lm(cfg, seed=3, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    toks = torch.randint(0, cfg.vocab, (2, 10), generator=torch.Generator().manual_seed(4))
    prompts = _lm_inputs(cfg, toks[:, :4])
    n = _chip_smoke().serve_linears(cfg, prefill=True) + 6 * _chip_smoke().serve_linears(cfg)
    logits, tokens = {}, {}
    for dev, model in models.items():
        engine = ServeEngine(cfg, model, max_len=32, device=dev)
        reset_launch_counts()
        with torch.inference_mode():
            lg, cache = engine.prefill(prompts)
            steps = [lg]
            for i in range(4, 10):
                lg, cache = engine.decode(cache, toks[:, i:i + 1].to(dev))
                steps.append(lg)
        logits[dev] = torch.stack(steps).cpu()
        if dev == "cuda":
            counts = launch_counts()
            assert (counts["mls_quantize_rows"], counts["mls_matmul"]) == (2 * n, n)
        tokens[dev] = engine.generate(prompts, 6).cpu()
    scale = max(1.0, float(logits["cpu"].abs().max()))
    assert float((logits["cuda"] - logits["cpu"]).abs().max()) <= 1e-3 * scale
    assert torch.equal(tokens["cuda"], tokens["cpu"])


# (M, K, N) of the LM training path's GEMMs at T = 256 tokens: chatglm3-6b's
# w_up (4096 -> 13696), w_down (13696 -> 4096) and wk (4096 -> 256), and
# mamba2-370m's in_proj (1024 -> 4384: its data gradient contracts over
# 4384, which qd_gemm pads to 4480), each forward (x (T, K) @ w), data
# gradient (e (T, N) @ w^T) and weight gradient (x^T @ e: both operands
# transposed copies, contracting over the tokens); "wgrad" marks the GEMMs
# whose operands are made as qd_gemm makes them, (T, rows) tensors copied
# transposed; then moonshot-v1-16b-a3b's attention (2048 -> 2048) and
# seamless-m4t's w_up (1024 -> 4096)
LM_TRAIN_GEMMS = [(256, 4096, 13696, "fwd"), (256, 13696, 4096, "dgrad"),
                  (4096, 256, 13696, "wgrad"), (256, 13696, 4096, "fwd"),
                  (256, 4096, 13696, "dgrad"), (13696, 256, 4096, "wgrad"),
                  (256, 4096, 256, "fwd"), (256, 256, 4096, "dgrad"),
                  (4096, 256, 256, "wgrad"), (256, 1024, 4384, "fwd"),
                  (256, 4384, 1024, "dgrad"), (1024, 256, 4384, "wgrad"),
                  (256, 2048, 2048, "fwd"), (256, 2048, 2048, "dgrad"),
                  (2048, 256, 2048, "wgrad"), (256, 1024, 4096, "fwd"),
                  (256, 4096, 1024, "dgrad"), (1024, 256, 4096, "wgrad")]


@pytest.mark.parametrize("gemm", LM_TRAIN_GEMMS, ids=str)
def test_k1_k3_match_plain_at_lm_training_shapes(cuda, gemm):
    """The training path's quantized linear: K1 ("nc", stochastic, the same
    rounding bytes to both) on both operands, K3 on their codes on the plan
    matmul_plan picks and on every other variant _checked_plan accepts (the
    walk, the ordered split, the wgmma variant), bit-identical to
    quantize_ref and mls_matmul_ref (<2,4>, k_block 128)."""
    import torch.nn.functional as F

    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    M, K, N, kind = gemm
    fmt, gen = EMFormat(2, 4), torch.Generator(device=cuda).manual_seed(M + K + N)
    pk = (-K) % 128  # qd_gemm pads the contraction to k_block
    qs = []
    for rows, scale in ((M, 1.0), (N, 0.02)):
        if kind == "wgrad":  # qd_gemm's copy of a transposed operand
            x = F.pad((torch.randn((K, rows), generator=gen, device=cuda) * scale).t(),
                      (0, pk)).contiguous()
        else:
            x = F.pad(torch.randn((rows, K), generator=gen, device=cuda) * scale, (0, pk))
        r = torch.randint(0, 256, x.shape, generator=gen, dtype=torch.uint8, device=cuda)
        got = mls_quantize(x, fmt, 128, r_u8=r, grouping="nc")
        want = quantize_ref(x, fmt, 128, r_u8=r, grouping="nc")
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        qs.append(got)
    (xc, xsg, xst), (wc, wsg, wst) = qs
    args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, 128)
    want = mls_matmul_ref(*args)
    plans = _chip_smoke().k3_plans(M, N, K + pk, 128, fmt)
    assert {p.variant for p in plans} == {"walk", "split", "wgmma"}
    for p in plans:
        assert torch.equal(mls_matmul(*args, "nc", plan=p), want), p


@pytest.mark.parametrize("name", ["chatglm3-6b", "mamba2-370m", "zamba2-7b"])
def test_smoke_train_step_on_the_card_agrees_with_the_cpu(cuda, name, monkeypatch):
    """One train step (sgdm, lr 1e-2) of a smoke config on the quantized
    kernels, with the key None (the trainer's fold_in patched to give none:
    the card's and the CPU's generators draw other rounding bytes), the same
    weights and tokens on the card and on the CPU: the loss within 1e-4
    relative, the grad norm within 1e-3 (the norms, attention and SSD sum in
    other orders, and one ulp before a quantizer can move an element to the
    neighbouring code: a few percent on one gradient), the weights within
    1e-5, and K1/K3 launched as chip_smoke.lm_train_launches says."""
    _train_step_agrees(cuda, name, monkeypatch, weight_tol=1e-5)


@pytest.mark.parametrize("name", ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
                                  "seamless-m4t-medium"])
def test_smoke_moe_and_encdec_train_step_on_the_card_agrees_with_the_cpu(cuda, name,
                                                                        monkeypatch):
    """The same step on the MoE and encoder-decoder smoke configs.  A code
    moved by a sum's order on the card moves more codes in every later
    quantizer, and these configs run more of them (the routed experts'
    fake-quant GEMMs; the encoder and the cross-attention): the
    embedding's update differed by 1.03e-5 (moonshot) and 1.21e-5
    (seamless) at lr 1e-2 on an H100.  The weights within 1e-4, the rest
    as above."""
    _train_step_agrees(cuda, name, monkeypatch, weight_tol=1e-4)


def _train_step_agrees(cuda, name, monkeypatch, weight_tol):
    import copy
    import dataclasses

    from repro_torch.configs import SHAPES, RunConfig, get_smoke_config
    from repro_torch.models.lm import init_lm
    from repro_torch.optim import cosine_schedule
    from repro_torch.train import make_train_step, trainer

    cfg = dataclasses.replace(get_smoke_config(name), quant_backend="pallas")
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], optimizer="sgdm", lr=1e-2)
    monkeypatch.setattr(trainer, "fold_in", lambda seed, step: None)
    step, init = make_train_step(run, cosine_schedule(run.lr, 0, 10))
    cpu_model = init_lm(cfg, seed=3, device="cpu")
    models = {"cpu": cpu_model, "cuda": copy.deepcopy(cpu_model).to(cuda)}
    toks = torch.randint(0, cfg.vocab, (2, 32), generator=torch.Generator().manual_seed(4))
    out = {}
    for dev, model in models.items():
        reset_launch_counts()
        batch = {k: v.to(model.emb.device) for k, v in _lm_inputs(cfg, toks).items()}
        model, _, m = step(model, init(model), batch)
        out[dev] = (float(m["loss"]), float(m["grad_norm"]),
                    {k: p.detach().cpu() for k, p in model.named_parameters()})
        if dev == "cuda":
            counts = launch_counts()
            want = _chip_smoke().lm_train_launches(cfg)
            assert {k: counts[k] for k in want} == want
    (l0, g0, p0), (l1, g1, p1) = out["cpu"], out["cuda"]
    assert abs(l1 - l0) <= 1e-4 * abs(l0) and abs(g1 - g0) <= 1e-3 * abs(g0)
    for k, p in p0.items():
        assert float((p1[k] - p).abs().max()) <= weight_tol, k


def test_sweep_pallas_cell_on_the_card_launches_the_closed_form(cuda):
    """A reduced "pallas" ResNet-20 cell of the frontier sweep on the card:
    every step launches K1 120 and K3 60 times (chip_smoke.expected_launches
    over the 20 quantized convs), and every loss is finite."""
    from repro_torch.models.cnn import quantized_convs
    from repro_torch.sweep.grid import Cell
    from repro_torch.sweep.runner import cell_cnn_config, cell_qcfg, train_cell

    cell = Cell(arch="resnet20", fmt="mls_e2m4", backend="pallas", steps=3, batch=8, hw=8)
    convs = quantized_convs(cell_cnn_config(cell), cell.batch)
    want = _chip_smoke().expected_launches(cell_qcfg(cell), convs)
    assert want["mls_quantize_rows"] == 120 and want["mls_matmul"] == 60
    traj = train_cell(cell, cuda)
    assert all(np.isfinite(traj.losses))
    assert traj.launches == [want] * cell.steps


# ---------------------------------------------------------------------------
# the tile cache's choices (repro_torch.kernels.autotune)
# ---------------------------------------------------------------------------
def _tune_specs():
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels.implicit_conv import conv_geometry, conv_tune_dims

    F = EMFormat(2, 4)
    specs = [at.TuneSpec("gemm", s, F) for s in (
        (131072, 144, 16), (144, 131072, 16), (131072, 16, 144), (8192, 576, 64),
        (1000, 300, 50), (4, 4096, 13696), (4, 13696, 4096))]  # stages, ragged, LM decode
    specs += [at.TuneSpec("gemm", (2048, 576, 64), F, 144)]
    specs += [at.TuneSpec("gemm", (8192, 576, 64), F, 128, g) for g in ("c", "n", "none")]
    specs += [at.TuneSpec("gemm", (1000, 300, 50), EMFormat(*f), 64) for f in ((2, 1), (3, 1))]
    specs += [at.TuneSpec("quantize", s, F, 128, g) for s, g in (
        ((131072, 256), "nc"), ((144, 131072), "nc"), ((4, 4096), "nc"), ((1000, 384), "n"),
        ((8192, 4096), "nc"), ((1000, 384), "c"))]
    specs += [at.TuneSpec("quantize", (1000, 384), EMFormat(*f), 128) for f in ((2, 1), (3, 1))]
    for xs, ws, s in (((128, 16, 32, 32), (16, 16, 3, 3), 1), ((128, 16, 32, 32), (32, 16, 3, 3), 2),
                      ((128, 32, 16, 16), (32, 32, 3, 3), 1), ((128, 32, 16, 16), (64, 32, 3, 3), 2),
                      ((128, 64, 8, 8), (64, 64, 3, 3), 1)):
        g = conv_geometry(xs, ws, (s, s), "SAME")
        for grouping in (GROUPINGS if s == 1 and xs[1] == 16 else ["nc"]):
            specs.append(at.TuneSpec("conv", conv_tune_dims(g, 144), F, 144, grouping))
    return specs


@pytest.mark.parametrize("spec", _tune_specs(), ids=lambda s: s.key())
def test_every_tuning_candidate_matches_the_default_and_the_plain_version(cuda, spec):
    """Each candidate the tuner may pick (K3's walk and split at every tile
    width, K1's warp and block passes at every pass-A grid, including the
    block pass at width 128, K4 at every tile width and im2col) gives the
    default's bits and the plain version's."""
    from repro_torch.kernels import autotune as at

    want = at.config_call(spec, None, device="cuda")()
    default = at.config_call(spec, at.default_block_config(spec), device="cuda")()
    cands = at.candidates_for(spec)
    assert len(cands) > 1 or spec.grouping in ("c", "none")
    for config in cands:
        assert at.verify_config(spec, config, "cuda").ok, config
        got = at.config_call(spec, config, device="cuda")()
        torch.cuda.synchronize()
        for a, b, c in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, default, want))):
            assert torch.equal(a, b) and torch.equal(a, c), (spec.key(), config)


def test_the_seed_cache_checks_on_the_card(cuda, capsys):
    from repro_torch.kernels import autotune as at

    assert at.main(["--check"]) == 0, capsys.readouterr().err
    seed = at.TuneCache.load(at.SEED_CACHE_PATH)
    if seed.device == torch.cuda.get_device_name(0):  # the seed resolves on its own card
        at.invalidate_cache()
        spec = next(iter(at.specs_named("path")))
        assert at.resolve_block_config(spec.kind, spec.shape, spec.fmt, spec.grouping,
                                       k_block=spec.k_block, device=cuda) == seed.get(spec.key())


# ---------------------------------------------------------------------------
# the parallel slice: compress on K1, K4's emit path, a world-1 HSDP step
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("numel", [128 * 300, 1000 * 77 + 5])
@pytest.mark.parametrize("stochastic", [False, True], ids=["nearest", "bytes"])
def test_compress_on_k1_matches_its_plain_version(cuda, numel, stochastic):
    """``parallel.compress`` on rows (n, 128): K1 with its nearest mode (no
    byte read) or the rounding bytes, bit for bit the plain version."""
    from repro_torch.parallel import compress

    g, _ = _operand(31, 1, numel)
    rows = -(-numel // 128)
    r = (torch.from_numpy(np.random.default_rng(32).integers(0, 256, (rows, 128),
                                                               dtype=np.uint8))
         if stochastic else None)
    reset_launch_counts()
    got = compress.compress(g.to(cuda), r_u8=None if r is None else r.to(cuda))
    assert launch_counts()["mls_quantize_rows"] == 1
    want = compress.compress(g, r_u8=r)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert torch.equal(compress.decompress(*got, g.shape).cpu(),
                       compress.decompress(*want, g.shape))


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("shape", [((2, 16, 12, 12), (24, 16, 3, 3), (1, 1), "SAME", 144),
                                   ((2, 8, 9, 9), (80, 8, 3, 3), (2, 2), "VALID", 36),
                                   ((2, 256, 7, 7), (96, 256, 1, 1), (1, 1), "SAME", 128)],
                         ids=["3x3", "stride2-2tiles", "1x1-2groups"])
def test_k4_emit_codes_match_its_plain_version(cuda, shape, grouping):
    """K4's emit store path (its kEmit instances): y, the codes (M0, K0), the
    compact scales and s_t bit for bit the plain version's, y also equal
    to the default path's; the launch proves with its emit outputs."""
    xs, ws, stride, pad, k_block = shape
    x, _ = _operand(40, xs[0] * xs[1], xs[2] * xs[3])
    w, _ = _operand(41, ws[0], ws[1] * ws[2] * ws[3])
    x, w = x.reshape(xs), (w * 0.2).reshape(ws)
    from repro_torch.kernels import implicit_conv as ic

    geom = ic.conv_geometry(xs, ws, stride, pad)
    rx = torch.from_numpy(np.random.default_rng(42).integers(0, 256, (geom.m0, geom.k0),
                                                             dtype=np.uint8))
    kw = dict(fmt=EMFormat(2, 4), k_block=k_block, grouping=grouping)
    reset_launch_counts()
    got = implicit_conv_forward(x.to(cuda), w.to(cuda), rx.to(cuda), None, stride, pad, **kw,
                                emit_codes=True)
    specs = recorded_specs()
    want = implicit_conv_forward(x, w, rx, None, stride, pad, **kw, emit_codes=True)
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    plain = implicit_conv_forward(x.to(cuda), w.to(cuda), rx.to(cuda), None, stride, pad, **kw)
    assert torch.equal(plain, got[0])
    rep = verify_specs("implicit_conv:emit", specs)
    assert rep.ok and any("outputs[5]" in c.coverage for c in rep.calls)


def test_world_one_hsdp_step_equals_the_unwrapped_step(cuda):
    """The launcher's HSDP wrapping on a world of one (NCCL, mesh 1x1x1)
    takes the unwrapped ``make_train_step``'s step bit for bit."""
    import dataclasses
    import socket

    import torch.distributed as dist

    from repro_torch.configs import SHAPES, RunConfig, get_smoke_config
    from repro_torch.data import make_lm_iterator
    from repro_torch.launch import train as launcher
    from repro_torch.models import lm
    from repro_torch.train import make_train_step

    cfg = dataclasses.replace(get_smoke_config("mamba2-370m"), quant_backend="pallas",
                              remat="full")
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=4, seq_len=32)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        mesh = launcher.hsdp_mesh(1, device_type="cuda")
        sharded = launcher.shard_model(lm.init_lm(cfg, seed=0, device=cuda), mesh)
        plain = lm.init_lm(cfg, seed=0, device=cuda)
        opt_s, opt_p = init(sharded), init(plain)
        data = make_lm_iterator(batch=4, seq=32, vocab=cfg.vocab, device=cuda)
        for _ in range(2):
            batch = next(data)
            sharded, opt_s, ms = step(sharded, opt_s, launcher.local_batch(batch, mesh))
            plain, opt_p, mp = step(plain, opt_p, batch)
            assert torch.equal(ms["loss"], mp["loss"])
            assert torch.equal(ms["grad_norm"], mp["grad_norm"])
        for (k, a), (_, b) in zip(sharded.named_parameters(), plain.named_parameters()):
            assert torch.equal(a.full_tensor(), b.detach()), k
    finally:
        dist.destroy_process_group()
