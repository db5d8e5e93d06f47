"""The port's implicit-GEMM conv and its dispatch (kernels.implicit_conv on
the CPU, i.e. through the plain versions of the CUDA kernels) against the
JAX package.

The JAX implicit kernel itself does not run on this jax (``pl.load`` is
gone), so the port is held to the JAX package in two ways:

- the plain-jnp helpers of ``repro.kernels.implicit_conv`` (geometry,
  legality, dispatch, covered scales, element codes, the uint8 patch
  gather), which never touch the kernel: equal, bit for bit;
- the JAX package's statement that the implicit conv computes the im2col
  pipeline's function bit for bit: the port's ``conv_impl="implicit"``
  conv, forward and both gradients, against ``lowbit_conv_fused_ref`` /
  ``conv_fused_grads_ref``, tolerance 0 (the 5x5 input gradient as in
  ``test_torch_lowbit_conv.py``: a stated col2im sum order).

Rounding is deterministic unless a test says otherwise; inputs come from
numpy with a seed.  The group scales compared below come from normal data,
whose group ratios stay far above the range where ``jnp.exp2`` is inexact
(ROADMAP queue 3); the tests assert that.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.kernels.implicit_conv as jic  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import formats as jformats  # noqa: E402
from repro.kernels import conv_fused_grads_ref, lowbit_conv_fused_ref  # noqa: E402
from repro.kernels import lowbit_conv as lowbit_conv_jax  # noqa: E402
from repro.kernels import ref as jax_ref  # noqa: E402
from repro_torch.core import GS_FMT_DEFAULT, EMFormat, QuantConfig  # noqa: E402
from repro_torch.kernels import implicit_conv as ic  # noqa: E402
from repro_torch.kernels import lowbit_conv  # noqa: E402
from repro_torch.kernels import lowbit_conv_fused  # noqa: E402
from repro_torch.kernels.ref import im2col as ref_im2col  # noqa: E402

# jitted: one XLA compile per conv instead of one per eager op and group
_jax_fwd = jax.jit(lowbit_conv_fused_ref, static_argnums=(2, 3, 4, 5))
_jax_grads = jax.jit(conv_fused_grads_ref, static_argnums=(3, 4, 5, 6))
_jax_covered_scale = jax.jit(jic.covered_tensor_scale, static_argnums=1)
_jax_codes = jax.jit(jic.elementwise_codes, static_argnums=2)
_jax_patches = jax.jit(jic.patches_u8, static_argnums=1)
_jax_x_scales = jax.jit(jic._implicit_x_scales, static_argnums=(1, 2, 3, 4, 5))

GROUPINGS = ["nc", "c", "n", "none"]
FORMATS = [(2, 4), (2, 1)]
FMT = EMFormat(*FORMATS[0])

# (N, C, H/W, O, ksize, stride, padding, k_block): the cases of
# test_torch_lowbit_conv.py, each with a legal k_block (several groups
# where C allows), and a VALID/stride-2 conv whose last row and column no
# patch covers.
CASES = [
    (2, 5, 9, 7, 3, (1, 1), "SAME", 9),
    (2, 5, 9, 7, 3, (2, 2), "VALID", 45),
    (1, 3, 8, 4, 1, (1, 1), "SAME", 3),
    (2, 4, 10, 6, 3, (2, 1), "SAME", 18),
    (1, 7, 7, 5, 5, (1, 1), [(2, 2), (2, 2)], 25),
    (2, 4, 8, 6, 3, (2, 2), "SAME", 18),  # ResNet-20's downsampling conv
    (2, 4, 10, 6, 3, (2, 2), "VALID", 36),  # uncovered tail
    (2, 4, 8, 6, 1, (2, 2), "SAME", 4),  # 1x1 stride 2: every other row and column uncovered
]
TAIL = CASES[6]
IDS = [f"c{i}" for i in range(len(CASES))]

# geometries for the dispatch: (x shape, w shape, stride, padding)
GEOMS = [
    ((2, 16, 32, 32), (16, 16, 3, 3), (1, 1), "SAME"),
    ((2, 16, 32, 32), (32, 16, 3, 3), (2, 2), "SAME"),
    ((2, 16, 32, 32), (32, 16, 1, 1), (2, 2), "SAME"),
    ((1, 6, 10, 9), (4, 6, 3, 3), (2, 2), "VALID"),
    ((1, 7, 7, 7), (5, 7, 5, 5), (1, 1), [(2, 2), (2, 2)]),
    ((1, 3, 4, 4), (2, 3, 5, 5), (1, 1), "VALID"),  # empty output
]
K_BLOCKS = [9, 18, 27, 32, 36, 128, 144, 1, 16, 25, 175]


def _inputs(seed, case):
    n, c, hw, o, k, stride, pad, _ = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, c, hw, hw)).astype(np.float32)
    if case is TAIL:
        x[:, :, -1, :] = 8.0  # only in the uncovered row and column
        x[:, :, :, -1] = -8.0
    w = (rng.standard_normal((o, c, k, k)) * 0.2).astype(np.float32)
    return x, w, stride, pad


def _geoms(case):
    n, c, hw, o, k, stride, pad, _ = case
    args = ((n, c, hw, hw), (o, c, k, k), stride, pad)
    return ic.conv_geometry(*args), jic.conv_geometry(*args)


def _cfgs(fmt, grouping, k_block, impl="implicit", stochastic=False):
    ours = QuantConfig(fmt=EMFormat(*fmt), k_block=k_block, grouping=grouping,
                       stochastic=stochastic, conv_impl=impl)
    ref = JQuantConfig(fmt=jformats.EMFormat(*fmt), k_block=k_block, grouping=grouping,
                       stochastic=False, backend="pallas", conv_impl="im2col")
    return ours, ref


# ---------------------------------------------------------------------------
# Geometry and dispatch
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("g", range(len(GEOMS)))
def test_conv_geometry_and_legality_match_jax(g):
    ours, ref = ic.conv_geometry(*GEOMS[g]), jic.conv_geometry(*GEOMS[g])
    assert [getattr(ours, f) for f in ("n", "c", "h", "w", "o", "kh", "kw", "sh", "sw",
                                       "ph_lo", "ph_hi", "pw_lo", "pw_hi")] == \
        list(ref.as_dims())
    for prop in ("hp", "wp", "oh", "ow", "kk", "m0", "k0"):
        assert getattr(ours, prop) == getattr(ref, prop), prop
    for kb in K_BLOCKS:
        assert ic.implicit_compatible(ours, kb) == jic.implicit_compatible(ref, kb), kb


def test_illegal_k_block_names_the_nearest_legal_one():
    geom = ic.conv_geometry((2, 16, 32, 32), (16, 16, 3, 3), (1, 1), "SAME")
    assert ic.implicit_compatible(geom, 128) == (
        False, "k_block=128 is not a multiple of kh*kw=9 (nearest legal: 72)")
    ok, reason = ic.implicit_compatible(geom, 9 * 5)
    assert not ok and reason.endswith("cb does not divide C=16 (nearest legal: 36)")
    assert ic.implicit_compatible(geom, 144) == (True, "")


@pytest.mark.parametrize("env", ["", "auto", "im2col", "implicit", " Implicit ", "bogus"])
def test_resolve_conv_impl_matches_jax(monkeypatch, env):
    """env > cfg.conv_impl > implicit-when-legal, and an explicit
    "implicit" on an illegal k_block raises, in both packages."""
    monkeypatch.setenv(ic.CONV_IMPL_ENV_VAR, env)
    n_raised = 0
    for g in GEOMS:
        ours_g, ref_g = ic.conv_geometry(*g), jic.conv_geometry(*g)
        for kb in (9, 18, 32, 36, 144):
            for impl in ic.CONV_IMPLS:
                ours = QuantConfig(k_block=kb, conv_impl=impl)
                ref = JQuantConfig(k_block=kb, conv_impl=impl, backend="pallas")
                try:
                    want = jic.resolve_conv_impl(ref_g, ref)
                except ValueError:
                    with pytest.raises(ValueError):
                        ic.resolve_conv_impl(ours_g, ours)
                    n_raised += 1
                    continue
                assert ic.resolve_conv_impl(ours_g, ours) == want, (g, kb, impl)
    # an explicit "implicit" is refused unless the env overrides it
    assert (n_raised > 0) == (env.strip().lower() not in ("auto", "im2col"))
    assert ic.CONV_IMPLS == jic.CONV_IMPLS and ic.CONV_IMPL_ENV_VAR == jic.CONV_IMPL_ENV_VAR


# ---------------------------------------------------------------------------
# Scales and codes computed outside the kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_covered_scale_codes_and_patches_match_jax(case):
    x, _, _, _ = _inputs(0, case)
    geom, jgeom = _geoms(case)
    s_t, xp = ic.covered_tensor_scale(torch.from_numpy(x), geom)
    js_t, jxp = _jax_covered_scale(jnp.asarray(x), jgeom)
    assert float(s_t) == float(js_t)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jxp))
    if case is TAIL:  # the tail is left out of the scale
        assert float(s_t) < 8.0 == float(xp.abs().max())
    for fmt in FORMATS:
        codes = ic.elementwise_codes(xp, s_t, EMFormat(*fmt))
        jcodes = _jax_codes(jxp, js_t, jformats.EMFormat(*fmt))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
        np.testing.assert_array_equal(ic.patches_u8(codes, geom).numpy(),
                                      np.asarray(_jax_patches(jcodes, jgeom)))


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case", [CASES[0], CASES[3], TAIL], ids=["c0", "c3", "tail"])
def test_implicit_x_scales_match_jax(case, grouping):
    x, _, _, _ = _inputs(1, case)
    kb = case[-1]
    geom, jgeom = _geoms(case)
    _, xp = ic.covered_tensor_scale(torch.from_numpy(x), geom)
    s_t, s_g = ic._implicit_x_scales(xp, geom, GS_FMT_DEFAULT, kb, grouping)
    js_t, js_g = _jax_x_scales(jnp.asarray(xp.numpy()), jgeom, jformats.FMT_IMAGENET,
                                        jformats.GS_FMT_DEFAULT, kb, grouping)
    assert float(s_t) == float(js_t)
    if grouping == "nc":
        assert s_g is None and js_g is None
        return
    assert float(s_g.min()) > 2.0**-12  # where jnp.exp2 is exact
    np.testing.assert_array_equal(s_g.numpy(), np.asarray(js_g))


# ---------------------------------------------------------------------------
# The conv, forward and both gradients
# ---------------------------------------------------------------------------
def _port_conv_and_grads(x, w, g, stride, pad, cfg, key=None):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = lowbit_conv_fused(xt, wt, key, stride, pad, cfg)
    (y * torch.from_numpy(g)).sum().backward()
    return y.detach().numpy(), xt.grad.numpy(), wt.grad.numpy()


def _check_against_jax(case, fmt, grouping, seed):
    x, w, stride, pad = _inputs(seed, case)
    ours, ref = _cfgs(fmt, grouping, case[-1])
    geom, _ = _geoms(case)
    assert ic.resolve_conv_impl(geom, ours) == "implicit"
    jpad = pad if isinstance(pad, str) else tuple(map(tuple, pad))  # hashable
    y_ref = np.asarray(_jax_fwd(jnp.asarray(x), jnp.asarray(w), None, stride, jpad, ref))
    g = np.random.default_rng(seed + 1).standard_normal(y_ref.shape).astype(np.float32)
    y, dx, dw = _port_conv_and_grads(x, w, g, stride, pad, ours)
    np.testing.assert_array_equal(y, y_ref)
    dx_ref, dw_ref = _jax_grads(jnp.asarray(x), jnp.asarray(w), jnp.asarray(g), None, stride,
                                jpad, ref)
    np.testing.assert_array_equal(dw, np.asarray(dw_ref))
    dx_ref = np.asarray(dx_ref)
    if case[4] <= 3:
        np.testing.assert_array_equal(dx, dx_ref)
    else:  # 5x5 col2im: XLA's own tap order (test_torch_lowbit_conv.py)
        atol = 25 * np.finfo(np.float32).eps * np.abs(dx_ref).max()
        np.testing.assert_allclose(dx, dx_ref, rtol=0, atol=atol)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("grouping", GROUPINGS)
def test_implicit_conv_matches_jax_on_the_downsampling_conv(grouping, fmt):
    """All four groupings and both formats on ResNet-20's stride-2 conv;
    grouping "none" takes the code-reuse weight gradient."""
    _check_against_jax(CASES[5], fmt, grouping, 2)


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case", CASES[:5] + [TAIL], ids=IDS[:5] + ["tail"])
def test_implicit_conv_matches_jax(case, grouping):
    _check_against_jax(case, (2, 4) if grouping in ("nc", "none") else (2, 1), grouping, 3)


def test_none_grouping_weight_gradient_reuses_the_forward_codes(monkeypatch):
    """On the implicit path with grouping "none" and nearest rounding, no
    fp32 patch matrix is built, forward or backward; the codes are coded
    once and gathered as bytes (bit-equality: the tests above)."""
    calls = []
    orig, orig_im2col = lowbit_conv._qd_gemm_precoded_x, lowbit_conv.im2col

    def no_im2col(*args, **kwargs):
        raise AssertionError("im2col called on the implicit path")

    def spy(*args, **kwargs):
        calls.append(args[0].dtype)
        return orig(*args, **kwargs)

    monkeypatch.setattr(lowbit_conv, "im2col", no_im2col)
    monkeypatch.setattr(lowbit_conv, "_qd_gemm_precoded_x", spy)
    x, w, stride, pad = _inputs(4, CASES[0])
    ours, _ = _cfgs((2, 4), "none", CASES[0][-1])
    g = np.ones((2, 7, 9, 9), np.float32)
    _port_conv_and_grads(x, w, g, stride, pad, ours)
    assert calls == [torch.uint8]
    # stochastic rounding re-quantizes the patches, as in the JAX package
    calls.clear()
    monkeypatch.setattr(lowbit_conv, "im2col", orig_im2col)
    ours_sr, _ = _cfgs((2, 4), "none", CASES[0][-1], stochastic=True)
    _port_conv_and_grads(x, w, g, stride, pad, ours_sr, key=3)
    assert calls == []


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case", [CASES[0], CASES[5], TAIL], ids=["c0", "c5", "tail"])
def test_implicit_equals_im2col_with_stochastic_rounding(case, grouping):
    """The lowering never changes the numbers: both draw the same rounding
    bytes from the same streams."""
    x, w, stride, pad = _inputs(5, case)
    geom, _ = _geoms(case)
    g = np.random.default_rng(6).standard_normal(
        (geom.n, geom.o, geom.oh, geom.ow)).astype(np.float32)
    out = {}
    for impl in ("im2col", "implicit"):
        cfg, _ = _cfgs((2, 4), grouping, case[-1], impl=impl, stochastic=True)
        out[impl] = _port_conv_and_grads(x, w, g, stride, pad, cfg, key=11)
    for a, b in zip(out["im2col"], out["implicit"]):
        np.testing.assert_array_equal(a, b)
    cfg_other, _ = _cfgs((2, 4), grouping, case[-1], stochastic=True)
    y_other = _port_conv_and_grads(x, w, g, stride, pad, cfg_other, key=12)[0]
    assert not np.array_equal(y_other, out["implicit"][0])


def test_implicit_forward_refuses_what_it_cannot_compute():
    x, w = torch.zeros(1, 4, 8, 8), torch.zeros(6, 4, 3, 3)
    fmt = EMFormat(2, 4)
    with pytest.raises(ValueError, match="nearest legal: 18"):
        ic.implicit_conv_forward(x, w, None, None, (1, 1), "SAME", fmt=fmt, k_block=32)
    with pytest.raises(ValueError, match="unknown grouping"):
        ic.implicit_conv_forward(x, w, None, None, (1, 1), "SAME", fmt=fmt, k_block=36,
                                 grouping="rows")
    with pytest.raises(ValueError, match="rounding bytes"):
        ic.implicit_conv_forward(x, w, torch.zeros(64, 35, dtype=torch.uint8), None, (1, 1),
                                 "SAME", fmt=fmt, k_block=36)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ic.implicit_conv_forward(x.to("meta"), w.to("meta"), None, None, (1, 1), "SAME",
                                 fmt=fmt, k_block=36)
    cfg = QuantConfig(fmt=fmt, k_block=32, conv_impl="implicit", stochastic=False)
    with pytest.raises(ValueError, match="not legal for this conv"):
        lowbit_conv_fused(x, w, None, (1, 1), "SAME", cfg)


# ---------------------------------------------------------------------------
# K4's staged halo band and pass A (csrc/implicit_conv.cu), emulated
# ---------------------------------------------------------------------------
def _k4_band_patches(x: torch.Tensor, geom, k_block: int) -> torch.Tensor:
    """The (M0, K0) patch values the kernel reads: per 64-row tile and
    scaling group, the band of cb channels x its padded rows x Wp staged
    from the unpadded input (zeros where the padding is), at a channel
    pitch of the tallest band; element (m, k) read at toff[k] + roff[m]."""
    bm = ic.TILE["kBM"]
    start, height = ic.band_rows(geom, bm)
    pitch = int(height.max())
    kk, cb = geom.kk, k_block // geom.kk
    k = np.arange(k_block)
    toff = torch.from_numpy(((k // kk) * pitch + (k % kk) // geom.kw) * geom.wp
                            + (k % kk) % geom.kw)
    out = torch.full((geom.m0, geom.k0), float("nan"))
    for tile, (gr0, bh) in enumerate(zip(start.tolist(), height.tolist())):
        m = np.arange(tile * bm, min(geom.m0, tile * bm + bm))
        q = m // geom.ow
        patch = (q // geom.oh) * geom.hp + (q % geom.oh) * geom.sh
        roff = torch.from_numpy((patch - gr0) * geom.wp + (m % geom.ow) * geom.sw)
        for g in range(geom.k0 // k_block):
            band = torch.zeros((cb, pitch, geom.wp))
            for row in range(bh):
                img, hh = divmod(gr0 + row, geom.hp)
                hh -= geom.ph_lo
                if img < geom.n and 0 <= hh < geom.h:
                    band[:, row, geom.pw_lo : geom.pw_lo + geom.w] = \
                        x[img, g * cb : (g + 1) * cb, hh]
            out[m, g * k_block : (g + 1) * k_block] = \
                band.reshape(-1)[roff[:, None] + toff[None, :]]
    return out


def _covered(x: torch.Tensor, geom) -> torch.Tensor:
    """|x| (N*C, hcov, wcov) with zeros where no patch covers the pixel: a
    row is covered iff (hh + ph) % sh < kh (``Cov`` in the kernel)."""
    hcov, wcov, _, _ = ic._amax_tiling(geom, ic.TILE)
    rows = x.reshape(geom.n * geom.c, geom.h, geom.w)[:, :max(hcov, 0), :max(wcov, 0)].abs()
    hh = (torch.arange(rows.shape[1]) + geom.ph_lo) % geom.sh < geom.kh
    ww = (torch.arange(rows.shape[2]) + geom.pw_lo) % geom.sw < geom.kw
    return rows * (hh[:, None] & ww[None, :])


def _k4_pass_a_max(x: torch.Tensor, geom) -> torch.Tensor:
    """conv_amax's partial maxima over the covered rows, then their max."""
    hcov, wcov, s, parts = ic._amax_tiling(geom, ic.TILE)
    rb = ic.TILE["kAmaxThreads"] // s
    rows = _covered(x, geom).reshape(-1, max(wcov, 0))
    turn = torch.arange(rows.shape[0]) // rb % parts
    partials = [rows[turn == b].amax() if (turn == b).any() else torch.tensor(0.0)
                for b in range(parts)]
    return torch.stack(partials).amax()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k4_band_gather_and_pass_a_equal_im2col(case):
    """Every patch value the kernel reads through its band addressing equals
    im2col's (SAME and VALID, strides 1 and 2, tiles that span two images,
    a ragged last tile, an uncovered tail), and pass A's covered max is
    the tensor scale of the patches (``covered_tensor_scale``, JAX's)."""
    x, _, _, _ = _inputs(0, case)
    geom, jgeom = _geoms(case)
    kb = case[-1]
    xt = torch.from_numpy(x)
    got = _k4_band_patches(xt, geom, kb)
    want, _ = ref_im2col(xt, (geom.kh, geom.kw), (geom.sh, geom.sw), geom.pads)
    assert torch.equal(got, want)
    s_t = _k4_pass_a_max(xt, geom)
    assert float(s_t) == float(want.abs().max())
    assert float(s_t) == float(_jax_covered_scale(jnp.asarray(x), jgeom)[0])


def _k4_scale_passes(x: torch.Tensor, geom, k_block: int, grouping: str):
    """``(s_t, compact s_g)`` as K4's "n" and "c" passes make them:
    "n" (conv_win_amax) a thread per output row takes its patch's max over
    the window clipped to the image, s_t the max of the blocks' partials;
    "c" the covered max of each (image, channel) plane (conv_chan_amax) at
    c * N + n, runs of cb * N per group (conv_group_reduce), then s_t and
    the group scales (conv_chan_scales)."""
    from repro_torch.core.quantize import quantize_group_scale

    if grouping == "n":
        m = torch.arange(geom.m0)
        img, q = m // (geom.oh * geom.ow), m % (geom.oh * geom.ow)
        i0, j0 = (q // geom.ow) * geom.sh - geom.ph_lo, (q % geom.ow) * geom.sw - geom.pw_lo
        s_r = torch.zeros(geom.m0)
        for i in range(geom.kh):
            for j in range(geom.kw):
                hh, ww = i0 + i, j0 + j
                ok = (hh >= 0) & (hh < geom.h) & (ww >= 0) & (ww < geom.w)
                v = x.abs()[img, :, hh.clamp(0, geom.h - 1), ww.clamp(0, geom.w - 1)].amax(1)
                s_r = torch.where(ok, torch.maximum(s_r, v), s_r)
        lanes = ic.TILE["kAmaxThreads"]
        parts = ic._win_blocks(geom.m0, ic.TILE)
        partials = [s_r[(m // lanes) % parts == b].amax() for b in range(parts)]
        s_t = torch.stack(partials).amax()
        s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
        return s_t, quantize_group_scale(s_r / s_t, GS_FMT_DEFAULT)[0][:, None]
    plane = _covered(x, geom).amax(dim=(1, 2))  # (N*C,) in (n, c) order
    pm = plane.reshape(geom.n, geom.c).t().reshape(-1)  # at c * N + n
    gmax = pm.reshape(geom.k0 // k_block, -1).amax(dim=1)
    s_t = gmax.amax()
    s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
    return s_t, quantize_group_scale(gmax / s_t, GS_FMT_DEFAULT)[0][None, :]


@pytest.mark.parametrize("grouping", ["c", "n"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_k4_c_and_n_scale_passes_equal_the_window_maxima(case, grouping):
    """The compact scales K4's "c" and "n" passes make on the card (a
    plane's covered max reduced by whole-channel groups; a patch's max over
    its clipped window), emulated, equal the window maxima of the padded
    input (``_implicit_x_scales``) and the JAX package's helper."""
    x, _, _, _ = _inputs(7, case)
    kb = case[-1]
    geom, jgeom = _geoms(case)
    xt = torch.from_numpy(x)
    s_t, s_g = _k4_scale_passes(xt, geom, kb, grouping)
    _, xp = ic.covered_tensor_scale(xt, geom)
    w_t, w_g = ic._implicit_x_scales(xp, geom, GS_FMT_DEFAULT, kb, grouping)
    js_t, js_g = _jax_x_scales(jnp.asarray(xp.numpy()), jgeom, jformats.FMT_IMAGENET,
                               jformats.GS_FMT_DEFAULT, kb, grouping)
    assert float(s_t) == float(w_t) == float(js_t)
    assert torch.equal(s_g, w_g)
    assert float(s_g.min()) > 2.0**-12  # where jnp.exp2 is exact
    np.testing.assert_array_equal(s_g.numpy(), np.asarray(js_g))


# ---------------------------------------------------------------------------
# emit_codes: the activation's codes and scales, as JAX's kernel emits them
# ---------------------------------------------------------------------------
_jax_im2col = jax.jit(lowbit_conv_jax._im2col, static_argnums=(1, 2, 3))
_jax_quantize_ref = jax.jit(jax_ref.quantize_ref, static_argnums=(1, 2, 3, 5))


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("case", [CASES[0], CASES[3], TAIL], ids=["c0", "c3", "tail"])
def test_emit_codes_equal_im2col_then_quantize_ref(case, grouping):
    """``implicit_conv_forward(..., emit_codes=True)`` (the plain version
    here) returns ``(y, codes (M0, K0), x_sg, s_t)``: JAX's ``_im2col`` of x
    quantized by JAX's ``quantize_ref`` on the same rounding bytes, codes
    and compact scales bit for bit, and ``y`` the conv without emit."""
    x, w, stride, pad = _inputs(4, case)
    geom, _ = _geoms(case)
    k_block = case[-1]
    rng = np.random.default_rng(5)
    r_x = rng.integers(0, 256, (geom.m0, geom.k0), dtype=np.uint8)
    r_w = rng.integers(0, 256, (geom.o, geom.k0), dtype=np.uint8)
    args = (torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(r_x),
            torch.from_numpy(r_w), stride, pad)
    kw = dict(fmt=FMT, k_block=k_block, grouping=grouping)
    y, codes, x_sg, s_t = ic.implicit_conv_forward(*args, **kw, emit_codes=True)
    cols, _ = _jax_im2col(jnp.asarray(x), tuple(w.shape[2:]), stride,
                          pad if isinstance(pad, str) else tuple(map(tuple, pad)))
    jc, jsg, jst = _jax_quantize_ref(cols, jformats.EMFormat(*FORMATS[0]), k_block,
                                     jformats.GS_FMT_DEFAULT, jnp.asarray(r_x), grouping)
    assert codes.dtype == torch.uint8 and tuple(codes.shape) == (geom.m0, geom.k0)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(x_sg.numpy(), np.asarray(jsg))
    assert s_t.item() == float(jst)
    assert torch.equal(y, ic.implicit_conv_forward(*args, **kw))
