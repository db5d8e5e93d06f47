"""Plain PyTorch versions of the CUDA kernels.

They compute the kernels' *quantized-domain* semantics exactly (integer
fractions, group scales, tensor scale factored out), so a kernel is held
bit-identical to them, and they are held bit-identical to the JAX package's
references in the CPU tests.  The kernel wrappers run them for tensors on
the CPU; ``chip_smoke.py`` runs them on the card as the comparison.  The
implicit conv's plain version is the im2col pipeline it fuses:
:func:`im2col`, then :func:`quantize_ref` and :func:`mls_matmul_ref`.
The verifier's planted-overlap control (K5) has :func:`sabotage_overlap_ref`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.formats import EMFormat, GS_FMT_DEFAULT
from repro_torch.core.quantize import (
    GroupSpec,
    broadcast_groups,
    group_reduce_max,
    quantize_elements,
    quantize_group_scale,
)

__all__ = [
    "decode_frac_int",
    "element_codes_ref",
    "grouping_spec",
    "im2col",
    "implicit_conv_ref",
    "mls_matmul_ref",
    "quantize_ref",
    "sabotage_overlap_ref",
    "sabotage_overlap_tiles",
]

Pads = tuple[tuple[int, int], tuple[int, int]]


def grouping_spec(grouping: str, k_block: int) -> GroupSpec:
    """GroupSpec of a 2-D (rows, contraction) operand for one grouping."""
    if grouping == "nc":
        return GroupSpec((1, k_block))
    if grouping == "c":
        return GroupSpec((None, k_block))
    if grouping == "n":
        return GroupSpec((1, None))
    if grouping == "none":
        return GroupSpec((None, None))
    raise ValueError(f"unknown grouping {grouping!r}")


def quantize_ref(
    x: torch.Tensor,
    fmt: EMFormat,
    k_block: int,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    r_u8: torch.Tensor | None = None,
    grouping: str = "nc",
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Dynamic quantization of a 2-D operand ``(M, K)`` (paper Alg. 2).

    ``r_u8`` is the uint8 stochastic-rounding source (``None`` ->
    round-to-nearest).  Returns ``(codes u8 (M, K), s_g f32, s_t f32
    scalar)``: ``codes`` packs ``sign|exp|man``, ``s_g`` is in the
    grouping's compact layout (``"nc"`` (M, K/k_block), ``"c"``
    (1, K/k_block), ``"n"`` (M, 1), ``"none"`` (1, 1)).
    """
    if x.ndim != 2:
        raise ValueError(f"quantize_ref takes a 2-D operand, got {tuple(x.shape)}")
    if grouping in ("nc", "c") and x.shape[1] % k_block:
        raise ValueError(f"K={x.shape[1]} is not a multiple of k_block={k_block}")
    spec = grouping_spec(grouping, k_block)
    xf32 = x.to(torch.float32)
    s_r = group_reduce_max(xf32.abs(), spec)
    s_t = torch.amax(s_r)
    s_t = torch.where(s_t > 0, s_t, torch.ones_like(s_t))
    s_g, _, _ = quantize_group_scale(s_r / s_t, gs_fmt)
    denom = s_t * broadcast_groups(s_g, spec, x.shape)
    return element_codes_ref(xf32, r_u8, denom, fmt), s_g, s_t


def element_codes_ref(
    x: torch.Tensor, r_u8: torch.Tensor | None, denom: torch.Tensor, fmt: EMFormat
) -> torch.Tensor:
    """Packed ``sign|exp|man`` uint8 codes of float32 ``x`` given its scale
    denominator ``s_t * s_g`` (broadcast against ``x``): paper Alg. 2
    l.9-16, the element step of every quantizer.  ``r_u8`` is the rounding
    source (``None``: round to nearest)."""
    # rounding bytes -> U(-1/2, 1/2) offsets (r + 0.5)/256 - 0.5, exact in fp32
    r = (r_u8.to(torch.float32) + 0.5) / 256.0 - 0.5 if r_u8 is not None else None
    absx = x.abs()
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    x_f = torch.where(denom > 0, absx / safe, torch.zeros_like(absx))
    _, exp_x, man_x = quantize_elements(x_f, fmt, r)
    sign_bit = (x < 0).to(torch.int32)
    codes = (sign_bit << (fmt.e + fmt.m)) | (exp_x << fmt.m) | man_x
    return codes.to(torch.uint8)


def decode_frac_int(codes: torch.Tensor, fmt: EMFormat) -> torch.Tensor:
    """uint8 codes -> signed integer fractions F (paper Eq. 7 operands),
    int32, with ``|value| = |F| * 2^(e_min - M)``."""
    c = codes.to(torch.int32)
    man = c & (2**fmt.m - 1)
    exp = (c >> fmt.m) & (2**fmt.e - 1)
    sign_bit = c >> (fmt.e + fmt.m)
    top = 2**fmt.e - 1
    is_denorm = exp == 0
    base = torch.where(is_denorm, man, 2**fmt.m + man)
    shift = torch.where(is_denorm, torch.zeros_like(exp), top - exp)
    f = base << shift
    return torch.where(sign_bit == 1, -f, f)


def mls_matmul_ref(
    x_codes: torch.Tensor,
    x_sg: torch.Tensor,
    x_st: torch.Tensor,
    w_codes: torch.Tensor,
    w_sg: torch.Tensor,
    w_st: torch.Tensor,
    fmt: EMFormat,
    k_block: int,
) -> torch.Tensor:
    """Quantized-domain GEMM (paper Eq. 6-8): x (M, K) codes @ w (K, N)
    codes -> f32 (M, N).

    The group scales may come in any compact grouping layout
    (``mls_matmul.sg_shapes``); they broadcast to the ``"nc"`` resolution
    (M, K/kb) / (K/kb, N), which subsumes the coarser layouts exactly.
    Each group's integer dot is exact in fp32; the groups are scaled by
    ``s_g^x * s_g^w`` and accumulated **in k order**, one group at a time,
    then the sum is multiplied once by ``(s_t^x * s_t^w) * 2^(2(e_min-M))``.
    That is the order of the TPU kernel (``mls_matmul.py`` ``_kernel``) and
    of the CUDA kernel; any other order may round differently.
    """
    M, K = x_codes.shape
    K2, N = w_codes.shape
    if K != K2 or K % k_block:
        raise ValueError(f"bad GEMM shapes {tuple(x_codes.shape)} @ {tuple(w_codes.shape)} "
                         f"for k_block={k_block}")
    nkb = K // k_block
    x_sg = x_sg.to(torch.float32).expand(M, nkb)
    w_sg = w_sg.to(torch.float32).expand(nkb, N)
    fx = decode_frac_int(x_codes, fmt).to(torch.float32)  # exact small ints
    fw = decode_frac_int(w_codes, fmt).to(torch.float32)
    acc = torch.zeros((M, N), dtype=torch.float32, device=x_codes.device)
    for g in range(nkb):
        ks = slice(g * k_block, (g + 1) * k_block)
        p = fx[:, ks] @ fw[ks, :]  # integer sums below 2^24: exact
        sp = x_sg[:, g : g + 1] * w_sg[g : g + 1, :]
        acc = acc + p * sp
    unit = 2.0 ** (2 * (fmt.e_min - fmt.m))
    return acc * ((x_st * w_st) * unit)


def im2col(x: torch.Tensor, ksize: tuple[int, int], stride: tuple[int, int], pads: Pads):
    """NCHW -> (N*OH*OW, C*kh*kw) patch matrix (+ output spatial dims).

    Feature order is (c, kh, kw), matching ``w.reshape(O, C*kh*kw)`` of an
    OIHW weight, so conv == cols @ w_mat.T.  ``pads`` are explicit
    ``((ph_lo, ph_hi), (pw_lo, pw_hi))``, applied with ``F.pad`` since
    ``F.unfold`` pads only symmetrically.
    """
    (ph_lo, ph_hi), (pw_lo, pw_hi) = pads
    xp = F.pad(x.float(), (pw_lo, pw_hi, ph_lo, ph_hi))
    n, ckk = x.shape[0], x.shape[1] * ksize[0] * ksize[1]
    oh = (xp.shape[2] - ksize[0]) // stride[0] + 1
    ow = (xp.shape[3] - ksize[1]) // stride[1] + 1
    cols = F.unfold(xp, ksize, stride=stride)  # (N, C*kh*kw, OH*OW)
    return cols.transpose(1, 2).reshape(n * oh * ow, ckk), (n, oh, ow)


def implicit_conv_ref(
    x: torch.Tensor,
    w: torch.Tensor,
    r_x: torch.Tensor,
    r_w: torch.Tensor,
    stride: tuple[int, int],
    pads: Pads,
    *,
    fmt: EMFormat,
    gs_fmt: EMFormat = GS_FMT_DEFAULT,
    k_block: int,
    grouping: str = "nc",
) -> torch.Tensor:
    """The implicit conv's function, computed the im2col way: fp32 NCHW
    ``x`` (N, C, H, W) and OIHW ``w`` -> fp32 (N, O, OH, OW).

    The patches ``im2col(x)`` (M0, K0) are quantized with rounding bytes
    ``r_x`` (M0, K0), the weight ``w.reshape(O, K0)`` with ``r_w``
    (O, K0), both in ``k_block``-wide groups of ``grouping``, and the codes
    are contracted by :func:`mls_matmul_ref`.  ``K0`` must be a multiple of
    ``k_block``.
    """
    o = w.shape[0]
    cols, (n, oh, ow) = im2col(x, tuple(w.shape[2:]), stride, pads)
    wt = w.reshape(o, -1).float()
    xc, xsg, xst = quantize_ref(cols, fmt, k_block, gs_fmt, r_x, grouping)
    wc, wsgT, wst = quantize_ref(wt, fmt, k_block, gs_fmt, r_w, grouping)
    y2d = mls_matmul_ref(xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, k_block)
    return y2d.reshape(n, oh, ow, o).permute(0, 3, 1, 2)


def sabotage_overlap_tiles(x: torch.Tensor, w: torch.Tensor) -> dict[tuple[int, int], torch.Tensor]:
    """The tile each program of K5 computes: ``(i, j) -> x[8i:8i+8] @
    w[:, 8j:8j+8]`` in fp32, each 8-deep k-tile's products summed in order
    and the k-tiles' partials added in order (``acc = 0 + p0``, then
    ``acc + p1``), one rounding per product and per sum, as the kernel
    does."""
    bm = bn = bk = 8
    tiles = {}
    for i in range(x.shape[0] // bm):
        for j in range(w.shape[1] // bn):
            xt, wt = x[i * bm : (i + 1) * bm], w[:, j * bn : (j + 1) * bn]
            acc = torch.zeros((bm, bn), dtype=torch.float32, device=x.device)
            for k in range(x.shape[1] // bk):
                p = torch.zeros_like(acc)
                for kk in range(k * bk, (k + 1) * bk):
                    p = p + xt[:, kk : kk + 1] * wt[kk : kk + 1, :]
                acc = acc + p
            tiles[(i, j)] = acc
    return tiles


def sabotage_overlap_ref(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """K5's function as the TPU's sequential grid runs it: programs in grid
    order, program (i, j) storing its tile at block (i, j - j % 2), the
    last writer winning; unwritten blocks keep NaN.  Returns ``(out, writes)``
    with ``writes`` (int32, out's shape) the number of stores to each
    element."""
    out = torch.full((x.shape[0], w.shape[1]), float("nan"), dtype=torch.float32,
                     device=x.device)
    writes = torch.zeros(out.shape, dtype=torch.int32, device=x.device)
    for (i, j), tile in sabotage_overlap_tiles(x, w).items():
        at = (slice(i * 8, (i + 1) * 8), slice((j - j % 2) * 8, (j - j % 2 + 1) * 8))
        out[at] = tile
        writes[at] += 1
    return out, writes
