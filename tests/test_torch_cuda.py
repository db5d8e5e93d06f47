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

Small, ragged shapes that the main path's shapes in ``chip_smoke.py`` do
not reach: M and N off the GEMM tile, both K3 plans (walk and ordered
split) on both bodies (int8 tensor cores; int32 for <3,1>), k_blocks off
the 16-wide k step, operands whose k axis is not contiguous; for K1
groups wider than a warp's limit, widths off the 4-wide vector access,
all-zero and -0.0 operands and a tensor max over many stride steps; the
E=0 format; and for the implicit conv k-blocks off the 32-wide chunk,
several k-blocks, two output-channel tiles, stride 2 with SAME
(asymmetric) and VALID (uncovered tail) padding, and a 1x1 conv.
Tolerance 0: the kernels reproduce the plain versions bit for bit.
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
from repro_torch.kernels.mls_matmul import MatmulPlan, matmul_plan  # noqa: E402
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
# main path's), "nmajor" the weight N-contiguous, "xT" x M-contiguous
PLAN_CASES = [(37, 96, 29, 32, "kmajor"), (70, 480, 130, 48, "nmajor"),
              (5, 108, 16, 36, "xT"), (20, 288, 64, 144, "kmajor")]
PLAN_PARAMS = [(fmt, case) for fmt in [(2, 4), (2, 1), (0, 4), (3, 1)] for case in PLAN_CASES
               if not (fmt == (3, 1) and case[3] == 144)]  # <3,1> x 144: 24 bits, refused


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


@pytest.mark.parametrize("variant", ["walk", "split"])
@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("fmt,case", PLAN_PARAMS, ids=str)
def test_matmul_plans_match_plain(cuda, fmt, case, grouping, variant):
    """Both K3 variants on the body the format takes, for ragged tiles,
    k_blocks on and off the 16-wide k step (cp.async or plain staging) and
    operands with either stride order."""
    m, k, n, kb, layout = case
    fmt = EMFormat(*fmt)
    cpu, card = _codes_on(cuda, fmt, grouping, m, k, n, kb, layout)
    assert (card[0].stride(1) == 1) == (layout != "xT")
    assert (card[3].stride(0) == 1) == (layout != "nmajor")
    auto = matmul_plan(m, n, k, kb, fmt)
    assert auto.body == ("int32" if fmt.max_fraction > 127 else "int8")
    plan = MatmulPlan(variant, auto.body, auto.bn, 0)
    want = mls_matmul(*cpu, fmt, kb, grouping)
    got = mls_matmul(*card, fmt, kb, grouping, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


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
    assert launch_counts() == {"mls_quantize_rows": 6, "mls_quantize_given_sg": 0,
                               "mls_matmul": 3, "implicit_conv": 0, "sabotage_overlap": 0}


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
    ("nc", True, {"mls_quantize_rows": 5, "mls_quantize_given_sg": 0, "mls_matmul": 2}),
    ("none", False, {"mls_quantize_rows": 0, "mls_quantize_given_sg": 5, "mls_matmul": 2}),
])
def test_implicit_conv_launch_counts(cuda, grouping, stochastic, want):
    """Forward: K4 and the weight's quantizer.  Backward: two GEMMs of
    two quantizes each, or with code reuse ("none", nearest) one code pass,
    the error's quantizer and the GEMM for the weight gradient."""
    x = torch.randn(2, 4, 8, 8, device=cuda, requires_grad=True)
    w = torch.randn(6, 4, 3, 3, device=cuda, requires_grad=True)
    cfg = QuantConfig(fmt=EMFormat(2, 4), k_block=36, grouping=grouping, stochastic=stochastic)
    reset_launch_counts()
    lowbit_conv_fused(x, w, 5, (1, 1), "SAME", cfg).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts() == {**want, "implicit_conv": 1, "sabotage_overlap": 0}


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
    (144, _K1_K3 | {"implicit_conv"})])
def test_full_width_step_launch_specs_verify_clean(cuda, k_block, kernels):
    graph = cifar_train_graph(k_block, device=cuda)
    cov, records = graph.run()
    specs = recorded_specs(records)
    assert {s.kernel for s, _ in specs} == kernels
    assert {key[1] for key in records} == {"cuda"}  # recorded on the card
    report = verify_specs(graph.name, specs)
    assert report.ok, report.violations
    assert report.max_integer_bits == (21 if k_block == 128 else 22)
    assert cov.quantized_fraction >= 0.99
