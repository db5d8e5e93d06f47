"""The port's MLS quantization (repro_torch.core / kernels.mls_quantize on
the CPU, i.e. the plain versions of the CUDA kernels) against the JAX
package: bit-exact on codes, group scales and tensor scales; and
``examples/torch_quickstart.py`` run with ``--device cpu``, its group-wise
quantization bit for bit the JAX package's (``examples/quickstart.py``'s
first step) on the same tensor.

Inputs and uint8 rounding bytes are made with numpy from a seed and fed to
both packages.  One documented difference: ``jnp.exp2`` on XLA's CPU
backend is not exact for integer exponents at or below -15, so the JAX
group scale of a group whose max is below 2^-12 of the tensor's is not the
power of two its docstring promises; the port builds exact powers, and the
comparisons use inputs whose group ratios stay above that range.
"""
import pytest

torch = pytest.importorskip("torch")

import importlib  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import formats as jformats  # noqa: E402
from repro.core import quantize as jquantize  # noqa: E402
from repro.kernels.mls_quantize import mls_quantize_pallas  # noqa: E402
from repro.kernels.ref import quantize_ref as jax_quantize_ref  # noqa: E402
from repro_torch.core import (  # noqa: E402
    EMFormat,
    accumulation_bits,
    exponent_fraction,
    pow2,
    quantize_elements,
    quantize_group_scale,
)
from repro_torch.core.formats import GS_FMT_DEFAULT as GS_DEFAULT  # noqa: E402
from repro_torch.kernels import mls_quantize, rounding_bytes  # noqa: E402
from repro_torch.analysis.kernel_verify import verify_specs  # noqa: E402
from repro_torch.kernels.mls_quantize import TILE, col_tiling  # noqa: E402
from repro_torch.kernels.ref import element_codes_ref  # noqa: E402

qmod = importlib.import_module("repro_torch.kernels.mls_quantize")

FORMATS = [(2, 4), (2, 1), (0, 4)]
GROUPINGS = ["nc", "c", "n", "none"]


def _operand(seed, m=48, k=96):
    """Normal rows with per-row magnitudes spread over a decade."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)) * rng.uniform(0.2, 3.0, (m, 1))
    return x.astype(np.float32), rng.integers(0, 256, (m, k), dtype=np.uint8)


def _exact_exp2_exponents():
    """Integer exponents at which jnp.exp2 gives the exact power of two."""
    e = np.arange(-126, 1)
    got = np.asarray(jnp.exp2(jnp.asarray(e, jnp.float32)))
    return set(e[got == np.ldexp(np.float32(1), e)].tolist())


@pytest.mark.parametrize("e,m", FORMATS)
def test_format_constants_match_jax(e, m):
    ours, ref = EMFormat(e, m), jformats.EMFormat(e, m)
    for attr in ("e_min", "max_value", "element_bits", "product_bits", "max_fraction"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    np.testing.assert_array_equal(ours.grid(), ref.grid())
    for kb in (1, 32, 100, 128):
        assert accumulation_bits(ours, kb) == jformats.accumulation_bits(ref, kb)


def test_exponent_fraction_matches_jax():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.abs(rng.standard_normal(1000)) * 10.0 ** rng.integers(-30, 30, 1000),
        [0.0, 1.0, 2.0, 0.5, 1e-40, 1e-45, 3.4e38, 2.0**-126, 1.9999999],
    ]).astype(np.float32)
    e_t, f_t = exponent_fraction(torch.from_numpy(x))
    e_j, f_j = jformats.exponent_fraction(jnp.asarray(x))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))


def test_pow2_is_exact():
    e = np.arange(-160, 129, dtype=np.int32)
    with np.errstate(over="ignore"):  # 2^128 rounds to inf, as intended
        want = np.ldexp(np.float64(1), e).astype(np.float32)  # 0 below 2^-149
    np.testing.assert_array_equal(pow2(torch.from_numpy(e)).numpy(), want)


@pytest.mark.parametrize("gs", [(8, 1), (4, 0), (5, 1)])
def test_quantize_group_scale_matches_jax(gs):
    rng = np.random.default_rng(1)
    ratios = np.concatenate([
        rng.uniform(0, 1, 2000), 2.0 ** rng.uniform(-30, 0, 2000),
        [0.0, 1.0, 0.75, 0.5, 2.0**-12, 2.0**-20, 2.0**-130],
    ]).astype(np.float32)
    s_t, e_t, m_t = quantize_group_scale(torch.from_numpy(ratios), EMFormat(*gs))
    s_j, e_j, m_j = jquantize.quantize_group_scale(jnp.asarray(ratios), jformats.EMFormat(*gs))
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    # the port's scale is exactly (1 + man/2^Mg) * 2^-exp ...
    exact = ((1.0 + m_t.numpy() / 2.0 ** gs[1]) * np.ldexp(1.0, -e_t.numpy())).astype(np.float32)
    np.testing.assert_array_equal(s_t.numpy(), exact)
    # ... and equals JAX's wherever jnp.exp2 is exact at that exponent
    ok = np.isin(-e_t.numpy(), list(_exact_exp2_exponents()))
    assert ok.sum() > 1000
    np.testing.assert_array_equal(s_t.numpy()[ok], np.asarray(s_j)[ok])


@pytest.mark.parametrize("e,m", FORMATS)
@pytest.mark.parametrize("stochastic", [False, True])
def test_quantize_elements_matches_jax(e, m, stochastic):
    rng = np.random.default_rng(2)
    x_f = np.concatenate([rng.uniform(0, 1, 4000), EMFormat(e, m).grid(), [0.0, 1.0]])
    x_f = x_f.astype(np.float32)
    r = ((rng.integers(0, 256, x_f.shape) + 0.5) / 256 - 0.5).astype(np.float32)
    r_t = torch.from_numpy(r) if stochastic else None
    r_j = jnp.asarray(r) if stochastic else None
    got = quantize_elements(torch.from_numpy(x_f), EMFormat(e, m), r_t)
    want = jquantize.quantize_elements(jnp.asarray(x_f), jformats.EMFormat(e, m), r_j)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("e,m", FORMATS)
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_mls_quantize_matches_jax_quantize_ref(e, m, grouping):
    x, r = _operand(3)
    got = mls_quantize(torch.from_numpy(x), EMFormat(e, m), 32, r_u8=torch.from_numpy(r),
                       grouping=grouping)
    want = jax_quantize_ref(jnp.asarray(x), jformats.EMFormat(e, m), 32,
                            r_u8=jnp.asarray(r), grouping=grouping)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("e,m", FORMATS[:2])
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_mls_quantize_matches_pallas_kernel(e, m, grouping):
    """Deterministic rounding (the kernel's constant byte 127) against the
    TPU kernel in interpret mode; <0,4> is left out (queue-3 defect of the
    reference: the Pallas kernel has no E=0 branch)."""
    x, _ = _operand(4, m=40, k=64)
    got = mls_quantize(torch.from_numpy(x), EMFormat(e, m), 32, grouping=grouping)
    want = mls_quantize_pallas(jnp.asarray(x), jformats.EMFormat(e, m), 32, key=None,
                               block_m=16, interpret=True, grouping=grouping)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_all_zero_operand_and_zero_groups():
    x = np.zeros((8, 64), np.float32)
    x[:4, :32] = np.random.default_rng(5).standard_normal((4, 32))
    codes, s_g, s_t = mls_quantize(torch.from_numpy(x), EMFormat(2, 4), 32)
    c_j, _, t_j = jax_quantize_ref(jnp.asarray(x), jformats.EMFormat(2, 4), 32,
                                   r_u8=jnp.full(x.shape, 127, jnp.uint8))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(c_j))
    assert float(s_t) == float(t_j)
    assert not codes.numpy()[4:].any() and not codes.numpy()[:, 32:].any()
    assert float(s_g[7, 1]) == 2.0**-120  # an all-zero group: the smallest scale
    codes0, _, s_t0 = mls_quantize(torch.zeros(4, 32), EMFormat(2, 4), 32)
    assert float(s_t0) == 1.0 and not codes0.any()


def test_rounding_bytes_and_shape_checks():
    g = torch.Generator().manual_seed(0)
    r1 = rounding_bytes((4, 8), g, torch.device("cpu"))
    assert r1.dtype == torch.uint8 and r1.shape == (4, 8)
    assert (rounding_bytes((4, 8), None, torch.device("cpu")) == 127).all()
    with pytest.raises(ValueError, match="multiple of k_block"):
        mls_quantize(torch.ones(4, 40), EMFormat(2, 4), 32)
    with pytest.raises(ValueError, match="contiguous float32"):
        mls_quantize(torch.ones(4, 64, dtype=torch.float64), EMFormat(2, 4), 32)
    with pytest.raises(ValueError, match="r_u8"):
        mls_quantize(torch.ones(4, 64), EMFormat(2, 4), 32, r_u8=torch.zeros(4, 64))
    with pytest.raises(ValueError, match="cuda or cpu"):
        mls_quantize(torch.ones(4, 64, device="meta"), EMFormat(2, 4), 32,
                     r_u8=torch.zeros(4, 64, dtype=torch.uint8, device="meta"))


# ---------------------------------------------------------------------------
# K1's two passes (csrc/mls_quantize.cu), emulated
# ---------------------------------------------------------------------------
def _nan_max(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The kernels' max: keeps NaN, as torch.amax does."""
    return torch.where((b > a) | torch.isnan(b), b, a)


def _two_pass_quantize(x, r, fmt, group_width, chunk, blocks):
    """Pass A: ``P`` blocks, block ``b`` taking max |x| over chunks b, b + P,
    ... of ``chunk`` elements; pass B: s_t from the partials (0 -> 1), then
    per group its max, scale and codes, as quantize_groups_warp/_block."""
    M, K = x.shape
    flat = x.reshape(-1)
    chunks = -(-flat.numel() // chunk)
    parts = max(1, min(blocks, chunks))
    partials = []
    for b in range(parts):
        m = torch.tensor(0.0)
        for c in range(b, chunks, parts):
            m = _nan_max(m, flat[c * chunk : (c + 1) * chunk].abs().max())
        partials.append(m)
    s_t = torch.tensor(0.0)
    for p in partials:
        s_t = _nan_max(s_t, p)
    s_t = s_t if s_t > 0 else torch.tensor(1.0)
    amax = x.reshape(M, K // group_width, group_width).abs().amax(-1)
    s_g = quantize_group_scale(amax / s_t, GS_DEFAULT)[0]
    codes = element_codes_ref(x, r, s_t * s_g.repeat_interleave(group_width, dim=1), fmt)
    return codes, s_g, s_t


@pytest.mark.parametrize("e,m", [(2, 4), (2, 1)])
@pytest.mark.parametrize("grouping", ["nc", "n"])
@pytest.mark.parametrize("values", ["normal", "zeros", "neg_zeros"])
@pytest.mark.parametrize("tile", [(64, 3), (TILE["kAmaxChunk"], TILE["kAmaxBlocks"])],
                         ids=["many_strides", "card"])
def test_two_pass_quantize_equals_quantize_ref(e, m, grouping, values, tile):
    """The partial maxima give torch.amax's s_t bit for bit (max is exact in
    any order), and the codes and group scales from it equal
    quantize_ref's and the JAX reference's: an all-zero operand takes
    s_t = 1, and -0.0 entries count as zeros.  (JAX's group scale of an
    all-zero group, 2^-120, is off in its last bits: the jnp.exp2 defect of
    the module docstring, so JAX's scales are compared above 2^-12.)"""
    x, r = _operand(6, m=12, k=96)
    if values == "zeros":
        x[:] = 0.0
    elif values == "neg_zeros":
        x[::3] = -0.0
        x[1] = -0.0
    fmt = EMFormat(e, m)
    kb = 32
    width = kb if grouping == "nc" else x.shape[1]
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    got = _two_pass_quantize(xt, rt, fmt, width, *tile)
    want = mls_quantize(xt, fmt, kb, r_u8=rt, grouping=grouping)
    jax_want = jax_quantize_ref(jnp.asarray(x), jformats.EMFormat(e, m), kb,
                                r_u8=jnp.asarray(r), grouping=grouping)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (codes, s_g, s_t), (j_codes, j_sg, j_st) = got, jax_want
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    assert float(s_t) == float(j_st)
    exact = s_g.numpy() >= 2.0**-12
    np.testing.assert_array_equal(s_g.numpy()[exact], np.asarray(j_sg)[exact])
    if values == "zeros":
        assert float(got[2]) == 1.0


def test_tensor_max_keeps_nan_like_torch_amax():
    x = torch.tensor([1.0, float("nan"), 3.0, -4.0])
    m = torch.tensor(0.0)
    for v in x.abs():
        m = _nan_max(m, v)
    assert torch.isnan(m) and torch.isnan(torch.amax(x.abs()))
    assert float(_nan_max(torch.tensor(2.0), torch.tensor(-0.0))) == 2.0


# ---------------------------------------------------------------------------
# K2's scale passes and code pass (csrc/mls_quantize.cu), emulated
# ---------------------------------------------------------------------------
_jax_quantize_ref = jax.jit(jax_quantize_ref, static_argnums=(1, 2),
                            static_argnames=("grouping",))


def _k2_emulate(x, r, fmt, group_width, vec):
    """mls_quantize_cols as the card runs it: pass A (K1's flat partial
    maxima for one group; else the column tiling's P row slices of column
    maxima and a max per group), quantize_scales (s_t from all maxima, 0
    and NaN -> 1; each group's ratio passed through unchanged when NaN),
    then the code pass, whose thread owns a column and its group's scale."""
    M, K = x.shape
    G = K // group_width
    if G == 1:
        flat = x.reshape(-1).abs()
        chunk, parts = TILE["kAmaxChunk"], qmod._amax_blocks(M * K, TILE)
        n_chunks = -(-flat.numel() // chunk)
        vals = [flat[c * chunk : (c + 1) * chunk] for b in range(parts)
                for c in range(b, n_chunks, parts)]
        gmax = [torch.stack([v.amax() for v in vals]).amax()]
    else:
        ct = col_tiling(M, K, vec, TILE["kColAmaxBlocks"], TILE["kThreads"])
        slice_of_row = (torch.arange(M) // ct.rb) % ct.p
        part = torch.stack([x[slice_of_row == p].abs().amax(dim=0) if (slice_of_row == p).any()
                            else torch.zeros(K) for p in range(ct.p)])
        gmax = [part[:, g * group_width : (g + 1) * group_width].amax() for g in range(G)]
    s_t = torch.tensor(0.0)
    for g in gmax:
        s_t = _nan_max(s_t, g)
    s_t = s_t if s_t > 0 else torch.tensor(1.0)
    ratio = torch.stack([g if torch.isnan(g) else g / s_t for g in gmax])
    s_g = quantize_group_scale(ratio, GS_DEFAULT)[0].reshape(1, G)
    per_col = s_g[0, torch.arange(K) // group_width]
    return element_codes_ref(x, r, s_t * per_col, fmt), s_g, s_t


# (M, K, grouping, k_block): "c" with float4 columns, scalar columns (K and
# k_block off 4), many row slices; "none" over K1's flat partials, with a
# width off 4 like the implicit "none" path's (N*C*Hp, Wp) operand
K2_CASES = [(48, 96, "c", 32), (6, 45, "c", 9), (300, 256, "c", 128), (5, 2048, "c", 128),
            (12, 34, "none", 34), (300, 256, "none", 128)]


@pytest.mark.parametrize("e,m", [(2, 4), (2, 1)])
@pytest.mark.parametrize("values", ["normal", "zeros", "tiny_group", "nan"])
@pytest.mark.parametrize("case", K2_CASES, ids=str)
def test_k2_scale_passes_equal_quantize_ref(case, values, e, m):
    """K2's own scale math (max exact in any order, s_t = 1 for an all-zero
    operand, NaN kept, group scales of maxima below 2^-14 of s_t) gives
    quantize_ref's codes, scales and tensor scale bit for bit, and the JAX
    reference's wherever ``jnp.exp2`` is exact (module docstring)."""
    M, K, grouping, kb = case
    x, r = _operand(11, m=M, k=K)
    if values == "zeros":
        x[:] = 0.0
    elif values == "tiny_group":
        x[:, :kb] *= 2.0**-20  # group 0 ("none": a region) far below s_t
    elif values == "nan":
        x[M // 2, K // 3] = np.nan
    fmt = EMFormat(e, m)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    width = kb if grouping == "c" else K
    vec = int(K % 4 == 0 and width % 4 == 0)
    got = _k2_emulate(xt, rt, fmt, width, vec)
    want = mls_quantize(xt, fmt, kb, r_u8=rt, grouping=grouping)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if values == "zeros":
        assert float(got[2]) == 1.0
    if values == "nan":
        assert float(got[2]) == 1.0  # NaN max -> 1, as quantize_ref
        return  # the JAX reference's NaN payloads are XLA's own
    j_codes, j_sg, j_st = _jax_quantize_ref(jnp.asarray(x), jformats.EMFormat(e, m), kb,
                                            r_u8=jnp.asarray(r), grouping=grouping)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(j_codes))
    assert float(got[2]) == float(j_st)
    exp = np.round(np.log2(got[1].numpy())).astype(int)
    exact = np.isin(exp, list(_exact_exp2_exponents()))
    np.testing.assert_array_equal(got[1].numpy()[exact], np.asarray(j_sg)[exact])


@pytest.mark.parametrize("shape", [(131072, 256, "c", 128), (144, 131072, "c", 128),
                                   (69632, 34, "none", 34), (144, 131072, "none", 128)],
                         ids=str)
def test_k2_launch_specs_prove_at_full_width_shapes(shape):
    """The descriptors of K2's launches at the operands a full-width step
    quantizes: the tall and wide "c" operands (2 and 1024 groups) and the
    implicit "none" path's (N*C*Hp, Wp) = (69632, 34) code operand; every
    launch proven exhaustively, each code written by one program."""
    M, K, grouping, kb = shape
    kernel, args = qmod.quantize_launch(M, K, kb, grouping)
    assert kernel == "mls_quantize_cols"
    specs = qmod.launch_spec_cols(*args)
    names = [s.kernel for s in specs]
    assert names == (["quantize_cols_amax", "quantize_cols_reduce"] if grouping == "c"
                     else ["quantize_amax"]) + ["quantize_scales", "quantize_codes"]
    rep = verify_specs(f"k2_{M}x{K}", [(s, 1) for s in specs])
    assert rep.ok, rep.violations
    assert all(c.exhaustive for c in rep.calls)
    codes = rep.calls[-1].coverage["outputs[3]"]
    assert codes["blocks_written"] == codes["output_blocks"] and codes["max_writers"] == 1
    given = qmod.launch_spec_given_sg(M, K, kb, 0, args[3])
    assert verify_specs("given", [(given, 1)]).ok


def test_quickstart_example_runs_on_the_cpu(capsys):
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "torch_quickstart.py"
    spec = importlib.util.spec_from_file_location("torch_quickstart", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    out = example.main(["--device", "cpu"])
    assert out["k1_identical"] and out["k3_identical"]
    assert out["are"] < out["are_per_tensor"] and out["qd_rel_err"] < 0.1
    want = jquantize.mls_quantize(jnp.asarray(out["x"].numpy()), jformats.FMT_IMAGENET,
                                  jquantize.GroupSpec((1, 128))).dequant()
    assert np.array_equal(np.asarray(want), out["unit"].numpy())
    assert "bit-identical: True" in capsys.readouterr().out
