"""Implicit-GEMM forward conv with the quantization fused in (K4), and the
choice between it and im2col.

The im2col lowering (:mod:`.lowbit_conv`) writes an fp32 patch matrix,
every input element ``kh*kw`` times, before the quantize kernel reads it.
:func:`implicit_conv_forward` computes the same function without it: on a
CUDA tensor one kernel (``csrc/implicit_conv.cu``, the TPU's
``implicit_conv.py`` ``_implicit_kernel``) walks the padded NCHW input
directly, quantizes each patch tile in the GEMM prologue (paper Alg. 2)
and contracts it with the weight codes in the quantized domain (Eq. 6-8).

The virtual GEMM is im2col's ``(M0 = N*OH*OW, K0 = C*kh*kw) @ (K0, O)``,
rows in (n, oh, ow) order and features in (c, kh, kw) order.  Scaling
groups must be whole channels' taps, ``k_block = cb*kh*kw`` with
``cb | C`` (:func:`implicit_compatible`); then the codes, scales and
rounding bytes are exactly those of the im2col pipeline, so the choice of
lowering never changes the numbers (stochastic rounding included: both
draw ``r_u8`` of shape (M0, K0) from the same stream).  The kernel stages
each output tile's halo band of the unpadded input in shared memory (the
padding is its zero fill) and makes the activation's scales in passes of
its own, for every grouping, inside its one C call; outside it is only
the weight's quantization (K1/K2, as in ``qd_gemm``).  On a CPU tensor the
wrapper runs the plain version,
:func:`repro_torch.kernels.ref.implicit_conv_ref`.
:func:`_implicit_x_scales` computes the activation's scales from window
maxima of a padded copy, as the JAX package's helper does: the plain
version of K4's scale passes, which the tests hold both to.

:func:`resolve_conv_impl` picks the lowering: ``REPRO_CONV_IMPL`` env >
``QuantConfig.conv_impl`` > implicit whenever legal.  The JAX package
consults its tuned-block cache between the last two; the port has no
autotuner yet, and the JAX seed cache's one conv entry picks "implicit"
too, so the decisions agree.  The kernel sizes its own tiles: there are no
block options; a conv whose band would not fit the kernel's shared memory
(:func:`band_fits`) stays on im2col.

:func:`covered_tensor_scale`, :func:`elementwise_codes` and
:func:`patches_u8` serve the weight gradient's reuse of the forward codes
under grouping "none" (:mod:`.lowbit_conv`).  :func:`launch_spec` and
:func:`launch_spec_scale` describe the kernel's launches for the static
verifier.
"""
from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.analysis.intervals import Accumulation
from repro_torch.core.formats import GS_FMT_DEFAULT, EMFormat, accumulation_bits
from repro_torch.core.lowbit import GROUPINGS, conv_pads
from repro_torch.core.quantize import quantize_group_scale

from . import build, launch
from .launch import LaunchSpec, Operand, Window
from .mls_matmul import _sg_operand, _strides, sg_shapes
from .mls_quantize import _fmt_args, mls_quantize, quantize_given_scales, rounding_bytes
from .ref import Pads, implicit_conv_ref

__all__ = [
    "CONV_IMPLS",
    "CONV_IMPL_ENV_VAR",
    "LAUNCHES",
    "TILE",
    "ConvGeom",
    "conv_geometry",
    "conv_pads",
    "covered_tensor_scale",
    "elementwise_codes",
    "band_fits",
    "band_rows",
    "implicit_compatible",
    "implicit_conv_forward",
    "launch_spec",
    "launch_spec_scale",
    "patches_u8",
    "resolve_conv_impl",
]

# Launches of K4's C entry points, counted where each is called: the
# conv ("implicit_conv") and its tensor-scale pass alone
# ("conv_tensor_scale", for the grouping-"none" weight gradient).
LAUNCHES = {"implicit_conv": 0, "conv_tensor_scale": 0}

# csrc/implicit_conv.cu's tile constants (implicit_conv_constants)
TILE = {"kBM": 64, "kThreads": 256, "kAmaxThreads": 256, "kAmaxBlocks": 2 * 132,
        "kBandBytesMax": 160 * 1024}

CONV_IMPL_ENV_VAR = "REPRO_CONV_IMPL"
CONV_IMPLS = ("auto", "im2col", "implicit")


# ---------------------------------------------------------------------------
# Geometry
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ConvGeom:
    """NCHW conv geometry with explicit padding."""

    n: int
    c: int
    h: int
    w: int
    o: int
    kh: int
    kw: int
    sh: int
    sw: int
    ph_lo: int
    ph_hi: int
    pw_lo: int
    pw_hi: int

    @property
    def hp(self) -> int:
        return self.h + self.ph_lo + self.ph_hi

    @property
    def wp(self) -> int:
        return self.w + self.pw_lo + self.pw_hi

    @property
    def oh(self) -> int:
        return (self.hp - self.kh) // self.sh + 1

    @property
    def ow(self) -> int:
        return (self.wp - self.kw) // self.sw + 1

    @property
    def kk(self) -> int:
        return self.kh * self.kw

    @property
    def m0(self) -> int:
        return self.n * self.oh * self.ow

    @property
    def k0(self) -> int:
        return self.c * self.kk

    @property
    def pads(self) -> Pads:
        return (self.ph_lo, self.ph_hi), (self.pw_lo, self.pw_hi)


def conv_geometry(x_shape, w_shape, stride, padding) -> ConvGeom:
    """``(x (N, C, H, W), w (O, C, kh, kw), stride, padding)`` ->
    :class:`ConvGeom`, with "SAME"/"VALID" resolved by :func:`conv_pads`."""
    n, c, h, w = (int(d) for d in x_shape)
    o, c2, kh, kw = (int(d) for d in w_shape)
    if c != c2:
        raise ValueError(f"input channels differ: x {tuple(x_shape)}, w {tuple(w_shape)}")
    sh, sw = (int(s) for s in stride)
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads((h, w), (kh, kw), (sh, sw), padding)
    return ConvGeom(n, c, h, w, o, kh, kw, sh, sw, ph_lo, ph_hi, pw_lo, pw_hi)


def implicit_compatible(geom: ConvGeom, k_block: int) -> tuple[bool, str]:
    """Can the implicit layout realize ``k_block``-wide scaling groups?

    Groups must be whole channels' taps: ``k_block = cb * kh * kw`` with
    ``cb | C``.  Returns ``(ok, reason)``; the reason names the nearest
    legal k_block when not.
    """
    kk = geom.kk
    if geom.oh < 1 or geom.ow < 1:
        return False, "empty output window"
    if k_block % kk:
        legal = _nearest_conv_k_block(geom, k_block)
        return False, (f"k_block={k_block} is not a multiple of kh*kw={kk} "
                       f"(nearest legal: {legal})")
    cb = k_block // kk
    if cb < 1 or geom.c % cb:
        legal = _nearest_conv_k_block(geom, k_block)
        return False, (f"k_block={k_block} needs cb={cb} whole channels per group but "
                       f"cb does not divide C={geom.c} (nearest legal: {legal})")
    return True, ""


def _nearest_conv_k_block(geom: ConvGeom, k_block: int) -> int:
    """Largest legal conv k_block (= cb*kh*kw, cb | C) not above k_block."""
    best = geom.kk
    for cb in range(1, geom.c + 1):
        if geom.c % cb == 0 and cb * geom.kk <= max(k_block, geom.kk):
            best = cb * geom.kk
    return best


def band_rows(geom: ConvGeom, block_m: int = TILE["kBM"]) -> tuple[np.ndarray, np.ndarray]:
    """Per ``block_m``-row output tile, the halo band K4 stages: its first
    row and its height in the image-major stack of padded rows (image
    ``n``'s padded row ``i`` is stack row ``n * Hp + i``).  Output row
    ``m = (n, oh, ow)``'s patch starts on stack row ``n * Hp + oh * sh``;
    a tile's band runs from its first row's to its last row's ``+ kh``
    (``csrc/implicit_conv.cu`` ``patch_row``)."""
    first = np.arange(0, geom.m0, block_m)
    last = np.minimum(first + block_m, geom.m0) - 1

    def patch_row(m):
        q = m // geom.ow
        return (q // geom.oh) * geom.hp + (q % geom.oh) * geom.sh

    start = patch_row(first)
    return start, patch_row(last) + geom.kh - start


@functools.lru_cache(maxsize=256)
def _tallest_band(geom: ConvGeom) -> int:
    return int(band_rows(geom)[1].max())


def band_fits(geom: ConvGeom, k_block: int) -> bool:
    """Does K4's tallest band of ``cb = k_block / (kh*kw)`` channels fit the
    shared memory the kernel gives it (``kBandBytesMax``)?  (Asked for
    every conv of every step: the band heights are kept per geometry.)"""
    return k_block // geom.kk * _tallest_band(geom) * geom.wp * 4 <= TILE["kBandBytesMax"]


def resolve_conv_impl(geom: ConvGeom, cfg) -> str:
    """``"im2col"`` or ``"implicit"`` for this conv.

    Precedence: ``REPRO_CONV_IMPL`` env (A/B runs) > ``cfg.conv_impl`` >
    implicit whenever :func:`implicit_compatible` and :func:`band_fits`.  An explicit
    ``"implicit"`` on an illegal ``k_block`` raises: the choice never
    changes the scaling groups.
    """
    env = os.environ.get(CONV_IMPL_ENV_VAR, "").strip().lower()
    if env and env not in CONV_IMPLS:
        raise ValueError(f"{CONV_IMPL_ENV_VAR}={env!r}: expected one of {CONV_IMPLS}")
    choice = env or cfg.conv_impl
    if choice == "im2col":
        return "im2col"
    ok, reason = implicit_compatible(geom, cfg.k_block)
    if ok and not band_fits(geom, cfg.k_block):
        ok, reason = False, (f"its halo band of {cfg.k_block // geom.kk} channels x "
                             f"{geom.wp} columns does not fit K4's "
                             f"{TILE['kBandBytesMax']} bytes of shared memory")
    if choice == "implicit" and not ok:
        raise ValueError(f"conv_impl='implicit' is not legal for this conv: {reason}")
    return "implicit" if ok else "im2col"


# ---------------------------------------------------------------------------
# Scales, computed from window maxima of the padded input (no patch matrix)
# ---------------------------------------------------------------------------
def _pad(x: torch.Tensor, geom: ConvGeom) -> torch.Tensor:
    return F.pad(x.float(), (geom.pw_lo, geom.pw_hi, geom.ph_lo, geom.ph_hi)).contiguous()


def _covered_abs_max(xp: torch.Tensor, geom: ConvGeom) -> torch.Tensor:
    """Abs-max of each conv window, (N, C, OH, OW).  Only pixels a patch
    covers count (VALID or a stride can leave a tail out), so its max is
    ``max|im2col(x)|``."""
    return F.max_pool2d(xp.abs(), (geom.kh, geom.kw), (geom.sh, geom.sw))


def _tap_abs_max(xp: torch.Tensor, geom: ConvGeom) -> torch.Tensor:
    """Abs-max of each feature over all patches, (C*kh*kw,) in (c, kh, kw)
    order: ``max|im2col(x)|`` along the patch axis."""
    a = xp.abs()
    cols = [a[:, :, i : i + 1 + geom.sh * (geom.oh - 1) : geom.sh,
              j : j + 1 + geom.sw * (geom.ow - 1) : geom.sw].amax(dim=(0, 2, 3))
            for i in range(geom.kh) for j in range(geom.kw)]
    return torch.stack(cols, dim=1).reshape(-1)


def _implicit_x_scales(xp: torch.Tensor, geom: ConvGeom, gs_fmt: EMFormat, kb: int,
                       grouping: str) -> tuple[torch.Tensor, torch.Tensor | None]:
    """``(s_t, compact s_g)`` of the activation, equal to what the im2col
    pipeline's quantizer computes from the patches, from the padded input
    ``xp``.  ``s_g`` is ``None`` for "nc" (the kernel makes those scales
    from its band), (M0, 1) for "n", (1, K0/kb) for "c" and ones (1, 1) for
    "none"."""
    if grouping in ("c", "none"):
        feat = _tap_abs_max(xp, geom)
        s_t = feat.amax()
    else:
        win = _covered_abs_max(xp, geom)
        s_t = win.amax()
    s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
    if grouping == "nc":
        return s_t, None
    if grouping == "n":
        s_r = win.amax(dim=1).reshape(geom.m0, 1)  # per patch
    elif grouping == "c":
        s_r = feat.reshape(geom.k0 // kb, kb).amax(dim=1)[None, :]
    else:
        return s_t, torch.ones((1, 1), dtype=torch.float32, device=xp.device)
    return s_t, quantize_group_scale(s_r / s_t, gs_fmt)[0]


def _amax_tiling(geom: ConvGeom, t: dict[str, int]) -> tuple[int, int, int, int]:
    """K4's pass A (``conv_amax``): the covered rows and columns of the
    unpadded input (``hcov``, ``wcov``), the threads per row ``s`` and the
    number of blocks, i.e. of partial maxima."""
    hcov = min(geom.h, (geom.oh - 1) * geom.sh + geom.kh - geom.ph_lo)
    wcov = min(geom.w, (geom.ow - 1) * geom.sw + geom.kw - geom.pw_lo)
    s = 32
    while s < wcov and s < t["kAmaxThreads"]:
        s *= 2
    rb = t["kAmaxThreads"] // s
    iters = -(-geom.n * geom.c * max(hcov, 0) // rb)
    return hcov, wcov, s, max(1, min(t["kAmaxBlocks"], iters))


def _win_blocks(m0: int, t: dict[str, int]) -> int:
    """``conv_win_amax``'s grid ("n"): a thread per output row, at most
    ``kAmaxBlocks`` blocks, i.e. partial maxima."""
    return max(1, min(t["kAmaxBlocks"], -(-m0 // t["kAmaxThreads"])))


def _scratch_floats(geom: ConvGeom, k_block: int, grouping: str, t: dict[str, int]) -> int:
    """The floats K4's scale passes write (its C entry point's ``scratch``):
    pass A's partials ("nc", "none"); the M0 patch maxima and their
    partials ("n"); the N*C plane maxima, G group maxima, s_t and the G
    group scales ("c", G = K0 / k_block)."""
    if grouping in ("nc", "none"):
        return _amax_tiling(geom, t)[3]
    if grouping == "n":
        return geom.m0 + _win_blocks(geom.m0, t)
    return geom.n * geom.c + 2 * (geom.k0 // k_block) + 1


def covered_tensor_scale(x: torch.Tensor, geom: ConvGeom) -> tuple[torch.Tensor, torch.Tensor]:
    """``(s_t, x_padded)``: the forward tensor scale, the abs-max over the
    pixels some patch covers (on CUDA K4's pass A, ``conv_tensor_scale``),
    and the padded input whose codes the caller gathers."""
    xp = _pad(x, geom)
    if x.device.type == "cpu":
        launch.record("conv_tensor_scale", "cpu", geom)
        with launch.plain_version():
            s_t = _covered_abs_max(xp, geom).amax()
            return torch.where(s_t > 0, s_t, torch.ones_like(s_t)), xp
    if x.device.type != "cuda":
        raise ValueError(f"covered_tensor_scale runs on cuda or cpu tensors, not {x.device}")
    xf = x.float().contiguous()
    parts = _amax_tiling(geom, TILE)[3]
    partials = torch.empty((parts,), dtype=torch.float32, device=x.device)
    s_t = torch.empty((), dtype=torch.float32, device=x.device)
    build.check(build.library().conv_tensor_scale(
        xf.data_ptr(), partials.data_ptr(), parts, s_t.data_ptr(), *_dims(geom)[:4],
        *_dims(geom)[5:], torch.cuda.current_stream(x.device).cuda_stream),
        "conv_tensor_scale")
    LAUNCHES["conv_tensor_scale"] += 1
    launch.record("conv_tensor_scale", "cuda", geom)
    return s_t, xp


def _dims(geom: ConvGeom) -> tuple[int, ...]:
    """The geometry arguments of K4's C entry points: n, c, h, w, o, kh, kw,
    sh, sw, ph, pw, hp, wp."""
    return (geom.n, geom.c, geom.h, geom.w, geom.o, geom.kh, geom.kw, geom.sh, geom.sw,
            geom.ph_lo, geom.pw_lo, geom.hp, geom.wp)


# ---------------------------------------------------------------------------
# The fused forward conv
# ---------------------------------------------------------------------------
def _check_bytes(r: torch.Tensor | None, shape: tuple[int, int], device) -> torch.Tensor:
    if r is None:
        return rounding_bytes(shape, None, device)
    if (tuple(r.shape) != shape or r.dtype != torch.uint8 or r.device != device
            or not r.is_contiguous()):
        raise ValueError(f"rounding bytes must be a contiguous uint8 {shape} tensor on "
                         f"{device}, got {r.dtype} {tuple(r.shape)} on {r.device}")
    return r


def implicit_conv_forward(
    x: torch.Tensor,
    w: torch.Tensor,
    r_x: torch.Tensor | None,
    r_w: torch.Tensor | None,
    stride,
    padding,
    *,
    fmt: EMFormat,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    k_block: int,
    grouping: str = "nc",
) -> torch.Tensor:
    """Quantized-domain forward conv as one implicit GEMM: ``x``
    (N, C, H, W), ``w`` (O, C, kh, kw) -> fp32 (N, O, OH, OW).

    ``r_x`` (N*OH*OW, C*kh*kw) and ``r_w`` (O, C*kh*kw) are the uint8
    rounding bytes of the patches and of the weight (``None``: the constant
    127, round to nearest), the shapes the im2col path draws.  ``k_block``
    must pass :func:`implicit_compatible`.
    """
    if grouping not in GROUPINGS:
        raise ValueError(f"unknown grouping {grouping!r}; expected one of {GROUPINGS}")
    geom = conv_geometry(x.shape, w.shape, stride, padding)
    ok, reason = implicit_compatible(geom, k_block)
    if not ok:
        raise ValueError(f"implicit_conv_forward: {reason}")
    if accumulation_bits(fmt, k_block) >= 24:
        raise ValueError(f"k_block={k_block} products of {fmt} values overflow the "
                         f"exact fp32 range of a group sum")
    if w.device != x.device:
        raise ValueError("x and w must share one device")
    r_x = _check_bytes(r_x, (geom.m0, geom.k0), x.device)
    r_w = _check_bytes(r_w, (geom.o, geom.k0), x.device)
    if x.device.type == "cpu":
        launch.record("implicit_conv", "cpu", geom, k_block, grouping, fmt)
        with launch.plain_version():
            return implicit_conv_ref(x, w, r_x, r_w, (geom.sh, geom.sw), geom.pads, fmt=fmt,
                                     gs_fmt=gs_fmt, k_block=k_block, grouping=grouping)
    if x.device.type != "cuda":
        raise ValueError(f"implicit_conv_forward runs on cuda or cpu tensors, not {x.device}")

    if not band_fits(geom, k_block):
        raise ValueError("implicit_conv_forward: the halo band does not fit K4's shared memory "
                         "(resolve_conv_impl keeps such convs on im2col)")
    dev = x.device
    xf = x.float().contiguous()
    # the kernel's scale passes write here
    scratch = torch.empty((_scratch_floats(geom, k_block, grouping, TILE),),
                          dtype=torch.float32, device=dev)
    # the weight side is qd_gemm's: (O, K0) quantized along K0
    wc, wsgT, wst = mls_quantize(w.reshape(geom.o, -1).float().contiguous(), fmt, k_block,
                                 gs_fmt, r_w, grouping)
    wcT, wsg = wc.t(), wsgT.t()
    out = torch.empty((geom.m0, geom.o), dtype=torch.float32, device=dev)
    build.check(build.library().implicit_conv(
        xf.data_ptr(), r_x.data_ptr(), scratch.data_ptr(), scratch.numel(),
        wcT.data_ptr(), *_strides(wcT), wsg.data_ptr(), *_strides(wsg), wst.data_ptr(),
        2.0 ** (2 * (fmt.e_min - fmt.m)), out.data_ptr(), *_dims(geom), k_block,
        _MODES[grouping], *_fmt_args(fmt, gs_fmt), torch.cuda.current_stream(dev).cuda_stream),
        "implicit_conv")
    LAUNCHES["implicit_conv"] += 1
    launch.record("implicit_conv", "cuda", geom, k_block, grouping, fmt)
    return out.reshape(geom.n, geom.oh, geom.ow, geom.o).permute(0, 3, 1, 2)


_MODES = {"nc": 0, "none": 1, "c": 2, "n": 3}  # the C entry point's groupings


def _amax_spec(geom: ConvGeom, t: dict[str, int]) -> LaunchSpec:
    """K4's pass A, ``conv_amax``: ``P`` blocks of ``rb`` row lanes take
    the covered rows ``(plane, hh < hcov)`` in turns of ``rb`` rows (block
    ``b`` turns ``b``, ``b + P``, ...), each lane a row's ``wcov`` covered
    columns; block ``b`` writes partial max ``b``.  The lanes and turns are
    inside the block."""
    hcov, _, s, parts = _amax_tiling(geom, t)
    rb = t["kAmaxThreads"] // s
    rows = geom.n * geom.c * max(hcov, 0)
    iters = -(-rows // rb)
    turns = max(1, -(-iters // parts))

    def x_row(b, lane, i):
        r = (i * parts + b) * rb + lane
        return (r // max(hcov, 1)) * geom.h + r % max(hcov, 1), 0

    return LaunchSpec(
        kernel="conv_amax", grid=(("block", parts), ("lane", rb), ("turn", turns)),
        sequential=2,
        operands=(Operand("args[0]", "x", (geom.n * geom.c * geom.h, geom.w), (1, geom.w),
                          x_row),
                  Operand("outputs[1]", "partials", (parts,), (1,), lambda b, lane, i: (b,),
                          output=True)),
        active=lambda b, lane, i: (i * parts + b) * rb + lane < rows)


def _win_spec(geom: ConvGeom, t: dict[str, int]) -> LaunchSpec:
    """K4's "n" scale pass, ``conv_win_amax``: ``P`` blocks of
    ``kAmaxThreads`` lanes take the output rows ``m = (turn * P + b) *
    kAmaxThreads + lane``; row ``m`` reads its image's planes around its
    patch and writes the patch's max |x|; block ``b`` writes partial max
    ``b``.  The lanes and turns are inside the block."""
    parts, lanes = _win_blocks(geom.m0, t), t["kAmaxThreads"]
    turns = max(1, -(-(-(-geom.m0 // lanes)) // parts))

    def row(b, lane, i):
        return (i * parts + b) * lanes + lane

    ohw = geom.oh * geom.ow
    return LaunchSpec(
        kernel="conv_win_amax", grid=(("block", parts), ("lane", lanes), ("turn", turns)),
        sequential=2,
        operands=(Operand("args[0]", "x", (geom.n, geom.c * geom.h * geom.w),
                          (1, geom.c * geom.h * geom.w),
                          lambda b, lane, i: (row(b, lane, i) // ohw, 0)),
                  Operand("outputs[1]", "patch_max", (geom.m0,), (1,),
                          lambda b, lane, i: (row(b, lane, i),), output=True),
                  Operand("outputs[2]", "partials", (parts,), (1,), lambda b, lane, i: (b,),
                          output=True)),
        active=lambda b, lane, i: row(b, lane, i) < geom.m0)


def _chan_specs(geom: ConvGeom, k_block: int, t: dict[str, int]) -> tuple[LaunchSpec, ...]:
    """K4's "c" scale passes: ``conv_chan_amax`` (a warp per (image,
    channel) plane, 8 to a block, writing the plane's covered max at
    ``c * N + n``, so a group's planes are one run), ``conv_group_reduce``
    (a block per group reads its run of ``cb * N`` plane maxima) and
    ``conv_chan_scales`` (one block: the G group maxima in, s_t and the G
    group scales out)."""
    planes, warps, G = geom.n * geom.c, t["kAmaxThreads"] // 32, geom.k0 // k_block
    cb = k_block // geom.kk

    def plane(b, w):
        return b * warps + w

    chan = LaunchSpec(
        kernel="conv_chan_amax", grid=(("block", -(-planes // warps)), ("warp", warps)),
        sequential=1,
        operands=(Operand("args[0]", "x", (planes, geom.h * geom.w), (1, geom.h * geom.w),
                          lambda b, w: (plane(b, w), 0)),
                  Operand("outputs[1]", "plane_max", (planes,), (1,),
                          lambda b, w: ((plane(b, w) % geom.c) * geom.n + plane(b, w) // geom.c,),
                          output=True)),
        active=lambda b, w: plane(b, w) < planes)
    reduce = LaunchSpec(
        kernel="conv_group_reduce", grid=(("group", G),), sequential=0,
        operands=(Operand("outputs[1]", "plane_max", (planes,), (cb * geom.n,), lambda g: (g,)),
                  Operand("outputs[2]", "group_max", (G,), (1,), lambda g: (g,), output=True)))
    scales = LaunchSpec(
        kernel="conv_chan_scales", grid=(("block", 1),), sequential=0,
        operands=(Operand("outputs[2]", "group_max", (G,), (G,), lambda b: (0,)),
                  Operand("outputs[3]", "s_t", (1,), (1,), lambda b: (0,), output=True),
                  Operand("outputs[4]", "s_g", (1, G), (1, G), lambda b: (0, 0), output=True)))
    return chan, reduce, scales


def launch_spec(geom: ConvGeom, k_block: int, grouping: str, fmt: EMFormat,
                device_type: str = "cpu") -> tuple[LaunchSpec, ...]:
    """K4 on one conv (``implicit_conv``): the scale passes of the grouping
    (pass A :func:`_amax_spec` for "nc" and "none", :func:`_win_spec` for
    "n", :func:`_chan_specs` for "c"), then the main launch, a block per
    ``kBM x bn`` tile of the virtual (M0, O) output (bn = 16, 32 or 64 from
    O), walking the ``K0 / k_block`` scaling groups in order.  Its patch
    rows come from the tile's halo band staged in shared memory, which the
    :class:`~.launch.Window` describes for ``prove_window_grid``; the
    rounding bytes, the compact scales of "c" and "n", the weight codes and
    the output are tiled as in K3.  The group dot is an exact integer dot
    of ``k_block`` decoded fractions."""
    t = launch.tile_constants("implicit_conv_constants", TILE, device_type)
    bm = t["kBM"]
    bn = 16 if geom.o <= 16 else 32 if geom.o <= 32 else 64
    m0, k0, o, nkb = geom.m0, geom.k0, geom.o, geom.k0 // k_block
    xs, ws = sg_shapes(grouping, m0, o, nkb)
    operands = [Operand("args[1]", "r_u8", (m0, k0), (bm, k_block), lambda i, j, g: (i, g),
                        masked=True)]
    if grouping in ("nc", "none", "n"):  # the main launch reduces the partials to s_t
        first: tuple[LaunchSpec, ...] = (
            _win_spec(geom, t) if grouping == "n" else _amax_spec(geom, t),)
        parts = first[0].shape[0]
        operands.append(Operand("outputs[2]" if grouping == "n" else "outputs[1]", "partials",
                                (parts,), (parts,), lambda i, j, g: (0,)))
        if grouping == "n":
            operands.append(_sg_operand("outputs[1]", grouping, xs, True, bm))
    else:
        first = _chan_specs(geom, k_block, t)
        operands += [Operand("outputs[3]", "s_t", (1,), (1,), lambda i, j, g: (0,)),
                     _sg_operand("outputs[4]", grouping, xs, True, bm)]
    operands += [Operand("args[2]", "w_codes", (k0, o), (k_block, bn), lambda i, j, g: (g, j),
                         masked=True),
                 _sg_operand("args[3]", grouping, ws, False, bn),
                 Operand("outputs[0]", "out", (m0, o), (bm, bn), lambda i, j, g: (i, j),
                         output=True, masked=True)]
    main = LaunchSpec(
        kernel="implicit_conv",
        grid=(("tile_m", -(-m0 // bm)), ("tile_n", -(-o // bn)), ("group", nkb)),
        sequential=1, operands=tuple(operands),
        accumulations=(Accumulation("dot", k_block, fmt.max_fraction),),
        window=Window(geom, k_block, bm, int(band_rows(geom, bm)[1].max()), t["kBandBytesMax"]),
        macs=m0 * k0 * o)
    return (*first, main)


def launch_spec_scale(geom: ConvGeom, device_type: str = "cpu") -> tuple[LaunchSpec, ...]:
    """K4's pass A alone (``conv_tensor_scale``): ``conv_amax``, then one
    block reduces the partials to the tensor scale (``conv_scale``)."""
    t = launch.tile_constants("implicit_conv_constants", TILE, device_type)
    amax = _amax_spec(geom, t)
    parts = amax.shape[0]
    scale = LaunchSpec(
        kernel="conv_scale", grid=(("block", 1),), sequential=0,
        operands=(Operand("outputs[1]", "partials", (parts,), (parts,), lambda b: (0,)),
                  Operand("outputs[0]", "s_t", (1,), (1,), lambda b: (0,), output=True)))
    return amax, scale


# ---------------------------------------------------------------------------
# Forward-code reuse for the weight-gradient GEMM (grouping "none")
# ---------------------------------------------------------------------------
def elementwise_codes(v: torch.Tensor, s_t: torch.Tensor, fmt: EMFormat) -> torch.Tensor:
    """uint8 codes of ``v`` against the tensor scale ``s_t`` alone, rounded
    to nearest: the grouping-"none" quantizer, whose codes commute with the
    patch gather.  On CUDA this is the given-scale kernel with ``s_g = 1``
    and the given ``s_t`` (which may differ from ``max|v|``)."""
    v2 = v.float().reshape(-1, v.shape[-1]).contiguous()
    ones = torch.ones((1, 1), dtype=torch.float32, device=v.device)
    codes = quantize_given_scales(v2, fmt, s_t, ones, v2.shape[1],
                                  rounding_bytes(v2.shape, None, v.device))
    return codes.reshape(v.shape)


def patches_u8(xq: torch.Tensor, geom: ConvGeom) -> torch.Tensor:
    """The im2col gather on uint8 codes: padded (N, C, Hp, Wp) ->
    (N*OH*OW, C*kh*kw) in (c, kh, kw) feature order, one byte per element
    (``F.unfold`` takes no integers)."""
    taps = [xq[:, :, i : i + 1 + geom.sh * (geom.oh - 1) : geom.sh,
               j : j + 1 + geom.sw * (geom.ow - 1) : geom.sw]
            for i in range(geom.kh) for j in range(geom.kw)]  # (N, C, OH, OW) each
    g = torch.stack(taps, dim=2)  # (N, C, KK, OH, OW)
    return g.permute(0, 3, 4, 1, 2).reshape(geom.m0, geom.k0)
