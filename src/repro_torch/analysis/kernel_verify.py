"""Static verifier for the port's CUDA kernels.

Two proofs per launch, computed from its descriptor
(:class:`repro_torch.kernels.launch.LaunchSpec`) without running anything:

**Grid / index-map coverage.**  The grid is enumerated (vectorized over
numpy arrays) and every operand's index map is evaluated at every grid
point, proving for each output that

* every output block is written at least once (no *gaps*);
* a block is written by one program only, revisited at most along the
  sequential axes that block walks in order and that the index map does
  not depend on: the accumulator pattern of K3 and K4's group walk.  Two
  writes from points that differ in a dependent axis, or in a parallel
  axis (blocks run at once, in no order, on the card), conflict
  (*overlap*);
* every read and write lands in bounds (*oob*), and array extents divide
  their blocks unless the kernel masks the ragged edge (*divisibility*).

K4 gathers its patches from a halo band staged in shared memory, at
addresses no block map describes; :func:`prove_window_grid` replays that
address arithmetic and proves the band holds every tap and fits.

**Accumulator exactness.**  Every integer accumulation the descriptor
declares (:class:`repro_torch.analysis.intervals.Accumulation`) must stay
below ``2^24`` (:data:`ACC_BUDGET_BITS`), so its int32 sum converts to fp32
exactly (paper Sec. V-B).  :func:`prove_matmul_accumulation_bits` equals
``core.formats.accumulation_bits``.

Entry points: :func:`verify_spec` (one launch), :func:`verify_entry` (a
``KERNEL_REGISTRY`` entry: every launch one forward, plus backward, makes),
:func:`verify_candidate`, :func:`verify_quantize_candidate` and
:func:`verify_implicit_conv_candidate` (legality oracles for an autotuner),
:func:`tensor_parallel_specs` (K1's split entries at a tensor-parallel
step's sharded operands), :func:`lm_train_specs` (K1 and K3 at an LM's
training GEMMs), and :func:`run_kernel_audit` (the ``--kernels``
section of ``python -m repro_torch.analysis.audit``, with the
``--sabotage`` negative controls).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.formats import FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat
from repro_torch.core.lowbit import QuantConfig
from repro_torch.kernels import implicit_conv, launch, recorded_specs
from repro_torch.kernels.autotune import BNS
from repro_torch.kernels.launch import LaunchSpec, Operand
from repro_torch.kernels.mls_matmul import launch_spec as matmul_spec
from repro_torch.kernels.mls_matmul import tuned_plan
from repro_torch.kernels.mls_quantize import quantize_launch

__all__ = [
    "ACC_BUDGET_BITS",
    "SABOTAGE_MODES",
    "CallReport",
    "KernelReport",
    "LM_AUDIT",
    "Violation",
    "prove_matmul_accumulation_bits",
    "prove_window_grid",
    "refused",
    "run_kernel_audit",
    "verify_candidate",
    "verify_entry",
    "verify_implicit_conv_candidate",
    "verify_quantize_candidate",
    "verify_spec",
    "verify_specs",
    "lm_train_specs",
    "writers_per_block",
]

ACC_BUDGET_BITS = 24  # fp32 integer-exactness budget (paper Sec. V-B)
_MAX_GRID_POINTS = 1 << 24  # full index-map enumeration cap

SABOTAGE_MODES = ("overlap_write", "deep_k", "drop_halo")


# ---------------------------------------------------------------------------
# report dataclasses
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Violation:
    """One statically proven defect in a launch's grid or arithmetic."""

    kind: str  # gap | overlap | oob | divisibility | overflow | unproven | illegal_config
    where: str  # operand ("outputs[0]", "args[2]"), "window_grid" or "body"
    detail: str

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class CallReport:
    """Verification result for one distinct launch."""

    kernel: str
    grid: tuple[tuple[str, int], ...]
    violations: list[Violation]
    coverage: dict
    accumulations: list[dict]
    max_integer_bits: int
    warnings: list[str]
    exhaustive: bool
    launches: int = 1

    @property
    def ok(self) -> bool:
        return not self.violations

    def to_json(self) -> dict:
        return {
            "kernel": self.kernel,
            "grid": [list(a) for a in self.grid],
            "launches": self.launches,
            "ok": self.ok,
            "exhaustive": self.exhaustive,
            "violations": [v.to_json() for v in self.violations],
            "coverage": self.coverage,
            "max_integer_accumulation_bits": self.max_integer_bits,
            "accumulations": self.accumulations,
            "warnings": self.warnings,
        }


@dataclasses.dataclass
class KernelReport:
    """Aggregated verification of one entry point or graph (all its launches)."""

    name: str
    calls: list[CallReport]

    @property
    def ok(self) -> bool:
        return bool(self.calls) and all(c.ok for c in self.calls)

    @property
    def max_integer_bits(self) -> int:
        return max((c.max_integer_bits for c in self.calls), default=0)

    def first_violation(self) -> str:
        """``"kind at where: detail"`` of the first violation ("" if none)."""
        for c in self.calls:
            for v in c.violations:
                return f"{v.kind} at {v.where}: {v.detail}"
        return ""

    @property
    def violations(self) -> list[Violation]:
        return [v for c in self.calls for v in c.violations]

    def to_json(self) -> dict:
        return {
            "name": self.name,
            "ok": self.ok,
            "num_launch_specs": len(self.calls),
            "max_integer_accumulation_bits": self.max_integer_bits,
            "calls": [c.to_json() for c in self.calls],
        }


def _window_report(name: str, viols: list[Violation], cov: dict) -> CallReport:
    return CallReport(kernel=f"{name}#window", grid=(), violations=viols,
                      coverage={"window_grid": cov} if cov else {}, accumulations=[],
                      max_integer_bits=0, warnings=[], exhaustive=True)


# ---------------------------------------------------------------------------
# coverage proofs
# ---------------------------------------------------------------------------
def _coords(spec: LaunchSpec) -> list[np.ndarray]:
    """Grid coordinates as int64 arrays that broadcast over the grid."""
    return list(np.ogrid[tuple(slice(0, n) for n in spec.shape)])


def _block_indices(spec: LaunchSpec, op: Operand, coords) -> tuple[np.ndarray, np.ndarray]:
    """The block index of ``op`` at every grid point, (points, ndim) with -1
    where the program does nothing, and the mask of working programs."""
    shape = spec.shape
    idx = np.stack([np.broadcast_to(np.asarray(v, dtype=np.int64), shape).ravel()
                    for v in op.index_map(*coords)], axis=1)
    active = np.ones(len(idx), dtype=bool)
    for pred in (spec.active, op.active):
        if pred is not None:
            active = active & np.broadcast_to(np.asarray(pred(*coords)), shape).ravel()
    idx[~active] = -1
    return idx, active


def _writers(spec: LaunchSpec, op: Operand, idx: np.ndarray, valid: np.ndarray):
    """Per output block, the number of distinct conflicting writers, and the
    dependent axes: a writer is a grid point's projection on the parallel
    axes and on the axes the index map depends on (between neighbouring
    programs that both write: one that does nothing depends on nothing)."""
    shape = spec.shape
    grid_idx = idx.reshape(*shape, idx.shape[1])
    grid_valid = valid.reshape(shape)

    def depends(d: int) -> bool:
        moved = np.any(np.diff(grid_idx, axis=d) != 0, axis=-1)
        both = np.take(grid_valid, range(shape[d] - 1), axis=d) & \
            np.take(grid_valid, range(1, shape[d]), axis=d)
        return bool(np.any(moved & both))

    deps = [d for d in range(len(shape)) if shape[d] > 1 and depends(d)]
    n_parallel = len(shape) - spec.sequential
    conflict = sorted(set(deps) | set(range(n_parallel)))
    nblocks = tuple(-(-s // b) for s, b in zip(op.shape, op.block))
    points = np.stack([c.ravel() for c in np.indices(shape)], axis=1)[valid]
    block_id = np.ravel_multi_index(idx[valid].T, nblocks)
    if conflict:
        writer_id = np.ravel_multi_index(points[:, conflict].T, [shape[d] for d in conflict])
        n_writers = math.prod(shape[d] for d in conflict)
    else:
        writer_id = np.zeros(len(points), dtype=np.int64)
        n_writers = 1
    pairs = np.unique(block_id * n_writers + writer_id)
    counts = np.bincount(pairs // n_writers, minlength=math.prod(nblocks)).reshape(nblocks)
    return counts, deps, block_id, points, conflict


def writers_per_block(spec: LaunchSpec, name: str) -> np.ndarray:
    """The number of distinct programs that store each block of output
    ``name`` (an array of the block-grid's shape): 1 everywhere for a
    well-formed launch; K5's is ``[[2, 0, 2, 0]]``."""
    op = next(o for o in spec.operands if o.name == name)
    idx, active = _block_indices(spec, op, _coords(spec))
    nblocks = np.array([-(-s // b) for s, b in zip(op.shape, op.block)])
    valid = active & np.all((idx >= 0) & (idx < nblocks), axis=1)
    return _writers(spec, op, idx, valid)[0]


def _check_operand(spec: LaunchSpec, op: Operand, coords) -> tuple[list[Violation], dict | None]:
    viols: list[Violation] = []
    if not op.masked:
        for i, (s, b) in enumerate(zip(op.shape, op.block)):
            if b < 1 or s % b:
                viols.append(Violation(
                    "divisibility", op.name,
                    f"dim {i}: array extent {s} not divisible by block {b} and the "
                    f"kernel does not mask the edge"))
    idx, active = _block_indices(spec, op, coords)
    nblocks = np.array([-(-s // b) for s, b in zip(op.shape, op.block)])
    inside = np.all((idx >= 0) & (idx < nblocks), axis=1)
    bad = np.flatnonzero(active & ~inside)
    if bad.size:
        pt = tuple(int(v) for v in np.unravel_index(bad[0], spec.shape))
        word = "write" if op.output else "read"
        viols.append(Violation(
            "oob", op.name,
            f"{op.role} {word} out of bounds: grid point {pt} -> block "
            f"{tuple(int(v) for v in idx[bad[0]])} outside {tuple(int(n) for n in nblocks)} "
            f"({bad.size} of {int(active.sum())} programs)"))
    if not op.output:
        return viols, None

    valid = active & inside
    counts, deps, block_id, points, conflict = _writers(spec, op, idx, valid)
    names = [a for a, _ in spec.grid]
    over = np.argwhere(counts > 1)
    if over.size:
        blk = tuple(int(v) for v in over[0])
        bid = int(np.ravel_multi_index(blk, counts.shape))
        pts = points[block_id == bid]
        proj = pts[:, conflict]
        pb = pts[np.flatnonzero(np.any(proj != proj[0], axis=1))[0]]
        viols.append(Violation(
            "overlap", op.name,
            f"output block {blk} written from grid points {tuple(int(v) for v in pts[0])} "
            f"and {tuple(int(v) for v in pb)}, which differ in grid axes "
            f"{[names[d] for d in conflict]} (parallel or index-map dependent): "
            f"conflicting writes, not a legal revisit"))
    missing = np.argwhere(counts == 0)
    if missing.size:
        viols.append(Violation(
            "gap", op.name,
            f"{len(missing)} of {counts.size} output blocks never written, e.g. block "
            f"{tuple(int(v) for v in missing[0])}"))
    per_block = np.bincount(block_id, minlength=counts.size)
    cov = {
        "output_blocks": int(counts.size),
        "blocks_written": int(np.count_nonzero(counts)),
        "max_writers": int(counts.max()) if counts.size else 0,
        "revisit_depth": int(per_block.max()) if per_block.size else 0,
        "index_map_grid_axes": [names[d] for d in deps],
    }
    return viols, cov


# ---------------------------------------------------------------------------
# K4's window proof
# ---------------------------------------------------------------------------
def prove_window_grid(geom, k_block: int, *, block_m: int = implicit_conv.TILE["kBM"],
                      band_rows: int | None = None,
                      band_bytes_max: int = implicit_conv.TILE["kBandBytesMax"]
                      ) -> tuple[list[Violation], dict]:
    """Coverage proof for K4's patch gather (``csrc/implicit_conv.cu``).

    Each ``block_m``-row M-tile stages a halo band in shared memory: ``cb =
    k_block / (kh*kw)`` channels x the padded rows its patches touch x the
    padded width, starting on its first row's patch row in the image-major
    stack of padded rows (``implicit_conv.band_rows``), at a channel pitch
    of ``band_rows`` rows, the tallest band of any tile.  This replays the
    kernel's addressing (row ``m`` of tile ``i`` is ``i * block_m + r``,
    decomposed into ``(n, oh, ow)``; feature ``k`` into ``(channel, tap)``)
    and proves:

    * every ``(n, oh, ow)`` is produced by exactly one M-tile row;
    * every tap of every row lies inside its tile's staged band: rows below
      ``start + min(height, band_rows)``, columns below ``wp``, and the
      band inside the stack of ``N`` padded images;
    * the band fits the kernel's shared memory, ``cb * band_rows * wp * 4
      <= band_bytes_max``;
    * every channel's taps lie in exactly one k-block (``k_block = cb *
      kh * kw`` with ``cb | C``).

    ``band_rows`` (default: the tallest band) stands in for the height the
    kernel stages; the ``drop_halo`` negative control sets it one row
    short, which must surface an ``oob``.
    """
    viols: list[Violation] = []
    kk, cb = geom.kk, k_block // geom.kk
    if k_block < kk or k_block % kk or geom.c % cb:
        viols.append(Violation(
            "divisibility", "window_grid",
            f"k_block={k_block} is not cb*kh*kw with cb | C={geom.c} (kh*kw={kk})"))
        return viols, {}
    start, height = implicit_conv.band_rows(geom, block_m)
    tallest = int(height.max())
    pitch = tallest if band_rows is None else band_rows
    staged = np.minimum(height, pitch)
    m0, ohw = geom.m0, geom.oh * geom.ow
    tiles = -(-m0 // block_m)
    m = (np.arange(tiles)[:, None] * block_m + np.arange(block_m)[None, :]).ravel()
    m = m[m < m0]  # the kernel masks rows past M0
    tile = m // block_m
    n, rem = m // ohw, m % ohw
    oh, ow = rem // geom.ow, rem % geom.ow
    # deepest tap row of each patch, in band rows; deepest tap column
    last_row = n * geom.hp + oh * geom.sh + geom.kh - 1 - start[tile]
    last_col = ow * geom.sw + geom.kw - 1
    for what, at, limit in (("image", n, np.full_like(n, geom.n)),
                            ("band row", last_row, staged[tile]),
                            ("tap column", last_col, np.full_like(n, geom.wp))):
        bad = np.flatnonzero(at >= limit)
        if bad.size:
            r = int(bad[0])
            viols.append(Violation(
                "oob", "window_grid",
                f"M-tile {int(tile[r])}: row {int(m[r])} (n={int(n[r])}, oh={int(oh[r])}, "
                f"ow={int(ow[r])}) reads {what} {int(at[r])} >= {int(limit[r])}: the staged "
                f"band is short of its taps ({bad.size} rows)"))
    beyond = np.flatnonzero(start + staged > geom.n * geom.hp)
    if beyond.size:
        viols.append(Violation(
            "oob", "window_grid",
            f"M-tile {int(beyond[0])}: band rows {int(start[beyond[0]])}.."
            f"{int(start[beyond[0]] + staged[beyond[0]]) - 1} run past the "
            f"{geom.n * geom.hp} padded rows of the input"))
    band_bytes = cb * pitch * geom.wp * 4
    if band_bytes > band_bytes_max:
        viols.append(Violation(
            "oob", "window_grid",
            f"the band of {cb} channels x {pitch} rows x {geom.wp} columns takes {band_bytes} "
            f"bytes > the kernel's {band_bytes_max} of shared memory"))
    produced = np.bincount((n * geom.oh + oh) * geom.ow + ow, minlength=geom.n * ohw)
    if (produced == 0).any():
        viols.append(Violation(
            "gap", "window_grid",
            f"{int((produced == 0).sum())} of {produced.size} (n, oh, ow) never produced"))
    if (produced > 1).any():
        viols.append(Violation(
            "overlap", "window_grid",
            f"(n, oh, ow) #{int(np.flatnonzero(produced > 1)[0])} produced by several rows"))
    nkb = geom.k0 // k_block
    f = np.arange(nkb * k_block)
    pairs = np.unique(f // kk * nkb + f // k_block)  # (channel, k-block)
    per_channel = np.bincount(pairs // nkb, minlength=geom.c)
    if per_channel.size != geom.c or (per_channel != 1).any():
        viols.append(Violation(
            "gap", "window_grid",
            f"k-blocks cover channels {per_channel.tolist()[:8]}... times instead of "
            f"0..{geom.c - 1} exactly once"))
    cov = {"output_rows": int(produced.size), "rows_produced": int(np.count_nonzero(produced)),
           "m_tiles": tiles, "k_blocks": nkb, "band_rows": pitch, "tallest_band": tallest,
           "band_bytes": band_bytes}
    return viols, cov


# ---------------------------------------------------------------------------
# one launch
# ---------------------------------------------------------------------------
def verify_spec(spec: LaunchSpec, name: str | None = None, launches: int = 1) -> CallReport:
    """Both proofs on one launch descriptor."""
    name = name or spec.describe()
    violations: list[Violation] = []
    coverage: dict = {}
    warnings: list[str] = []
    exhaustive = True
    npoints = math.prod(spec.shape)
    if npoints > _MAX_GRID_POINTS:
        warnings.append(f"grid {spec.shape} has {npoints} points > {_MAX_GRID_POINTS}; "
                        f"coverage not proven")
        exhaustive = False
    elif npoints:
        coords = _coords(spec)
        for op in spec.operands:
            viols, cov = _check_operand(spec, op, coords)
            violations += viols
            if cov is not None:
                coverage[op.name] = cov
    if spec.window is not None:
        w = spec.window
        viols, cov = prove_window_grid(w.geom, w.k_block, block_m=w.block_m,
                                       band_rows=w.band_rows,
                                       band_bytes_max=w.band_bytes_max)
        violations += viols
        coverage["window_grid"] = cov
    int_accs = [a for a in spec.accumulations if a.integer]
    max_bits = max((a.bits for a in int_accs), default=0)
    for a in int_accs:
        if a.bits >= ACC_BUDGET_BITS:
            violations.append(Violation(
                "overflow", "body",
                f"integer {a.kind} accumulation spans {min(a.bits, 9999)} bits (|bound| "
                f"{a.bound:g}, depth {a.depth}, operand bound {a.operand_bound:g}) >= "
                f"{ACC_BUDGET_BITS}: fp32 accumulation is no longer bit-exact"))
            break
    return CallReport(kernel=name, grid=spec.grid, violations=violations, coverage=coverage,
                      accumulations=[a.to_json() for a in spec.accumulations],
                      max_integer_bits=max_bits, warnings=warnings, exhaustive=exhaustive,
                      launches=launches)


def verify_specs(name: str, specs: list[tuple[LaunchSpec, int]]) -> KernelReport:
    """Verify distinct launches ``(spec, launches)`` under one report name."""
    calls = [verify_spec(s, f"{name}#{i} {s.describe()}", n) for i, (s, n) in enumerate(specs)]
    if not calls:
        calls = [CallReport(kernel=name, grid=(), coverage={}, accumulations=[],
                            max_integer_bits=0, warnings=[], exhaustive=False,
                            violations=[Violation("unproven", "body",
                                                  "no kernel launch recorded")])]
    return KernelReport(name=name, calls=calls)


def verify_entry(entry, device: str = "cuda") -> KernelReport:
    """Verify one ``repro_torch.kernels.registry.KERNEL_REGISTRY`` entry:
    every launch its forward (plus backward) made on ``device``."""
    return verify_specs(entry.name, recorded_specs(entry.run(device)))


# ---------------------------------------------------------------------------
# legality oracles (for an autotuner; the CUDA kernels size their own tiles)
# ---------------------------------------------------------------------------
def _unpack_qcfg(qcfg) -> tuple[EMFormat, int, EMFormat]:
    if isinstance(qcfg, QuantConfig):
        return qcfg.fmt, qcfg.k_block, qcfg.gs_fmt
    fmt, k_block = qcfg
    return fmt, int(k_block), GS_FMT_DEFAULT


def _quantize_specs(M: int, K: int, k_block: int, grouping: str, device: str,
                    config=None) -> list[tuple[LaunchSpec, int]]:
    """The quantizer launches ``mls_quantize`` makes on an (M, K) operand
    (K1 with ``config``'s variant and pass-A grid, default today's)."""
    kernel, args = quantize_launch(M, K, k_block, grouping, config)
    return recorded_specs(collections.Counter({(kernel, device, *args): 1}))


def _once(specs) -> list[tuple[LaunchSpec, int]]:
    return [(s, 1) for s in specs]


def refused(name: str, detail: str, kind: str = "illegal_config",
            where: str = "config") -> KernelReport:
    """A report whose one violation is a launch choice the kernel refuses
    (a warp per group over ``kWarpGroupMax``, a split over the workspace
    limit, K4 where its band does not fit, ...)."""
    return KernelReport(name, [CallReport(
        kernel=name, grid=(), coverage={}, accumulations=[], max_integer_bits=0, warnings=[],
        exhaustive=True, violations=[Violation(kind, where, detail)])])


def verify_candidate(shape: tuple[int, int, int], qcfg, grouping: str | None = None,
                     device: str = "cpu", config=None) -> KernelReport:
    """Legality of ``qd_gemm`` on an ``(M, K, N)`` GEMM: the two quantizer
    launches (x (M, Kp), the transposed weight (N, Kp), K padded to a
    multiple of k_block, at their default launches) and K3, on the plan of
    ``config`` (an ``autotune.BlockConfig``: variant and ``bn``; a split
    must keep its workspace within ``mls_matmul.WORKSPACE_LIMIT``) or, by
    default, ``matmul_plan``'s.  ``qcfg`` is a ``QuantConfig`` or a bare
    ``(fmt, k_block)`` pair (for pairs ``QuantConfig`` refuses)."""
    M, K, N = shape
    fmt, k_block, _ = _unpack_qcfg(qcfg)
    if grouping is None:
        grouping = qcfg.grouping if isinstance(qcfg, QuantConfig) else "nc"
    kp = -(-K // k_block) * k_block
    name = f"candidate_{M}x{K}x{N}_{fmt}_kb{k_block}_{grouping}"
    plan = None
    if config is not None:
        try:
            plan = tuned_plan(config.variant, config.bn, M, N, kp, k_block, fmt)
        except ValueError as e:
            return refused(name, f"K3 cannot run {config}: {e}")
    specs = (_quantize_specs(M, kp, k_block, grouping, device)
             + _quantize_specs(N, kp, k_block, grouping, device)
             + _once(matmul_spec(M, N, kp, k_block, grouping, fmt, plan, device_type=device)))
    return verify_specs(name, specs)


def verify_quantize_candidate(shape: tuple[int, int], fmt: EMFormat, k_block: int,
                              gs_fmt: EMFormat = GS_FMT_DEFAULT, grouping: str = "nc",
                              device: str = "cpu", config=None) -> KernelReport:
    """Legality of the quantizer launch on an ``(M, K)`` operand, with
    ``config``'s variant and pass-A grid (default today's)."""
    M, K = shape
    name = f"qcandidate_{M}x{K}_{fmt}_kb{k_block}_{grouping}"
    if K % k_block:
        return refused(name, f"K={K} is not a multiple of k_block={k_block}", "divisibility",
                       "args[0]")
    try:
        specs = _quantize_specs(M, K, k_block, grouping, device, config)
    except ValueError as e:
        return refused(name, str(e))
    return verify_specs(name, specs)


def verify_implicit_conv_candidate(geom, fmt: EMFormat, k_block: int, grouping: str = "nc",
                                   gs_fmt: EMFormat = GS_FMT_DEFAULT,
                                   device: str = "cpu", config=None) -> KernelReport:
    """Legality of the implicit conv on one geometry: the layout and the
    halo band's shared memory, then the weight's quantizer launch and K4 at
    ``config``'s tile width (default the narrowest that holds O), whose
    window the verifier proves."""
    name = f"iconv_{geom.n}x{geom.c}x{geom.h}x{geom.w}_o{geom.o}k{geom.kh}s{geom.sh}" \
           f"_{fmt}_kb{k_block}_{grouping}"
    ok, reason = implicit_conv.implicit_compatible(geom, k_block)
    if not ok:
        return KernelReport(name, [_window_report(
            name, [Violation("divisibility", "window_grid", reason)], {})])
    ok, reason = implicit_conv.implicit_legal(geom, k_block)
    if not ok:
        return refused(name, reason, "oob", "window_grid")
    bn = None if config is None else config.bn
    if bn is not None and bn not in BNS:
        return refused(name, f"K4's tile width is one of 16, 32, 64, not {bn}")
    specs = (_quantize_specs(geom.o, geom.k0, k_block, grouping, device)
             + _once(implicit_conv.launch_spec(geom, k_block, grouping, fmt, bn,
                                                   device_type=device)))
    return verify_specs(name, specs)


def prove_matmul_accumulation_bits(fmt: EMFormat, k_block: int) -> int:
    """The verifier's bound on K3's integer accumulator width for one
    ``(fmt, k_block)``: equal to ``core.formats.accumulation_bits`` for every
    pair, as the tests assert."""
    return max(verify_spec(s).max_integer_bits
               for s in matmul_spec(8, 8, 2 * k_block, k_block, "nc", fmt))


# ---------------------------------------------------------------------------
# sabotage negative controls (the gate must fail on each)
# ---------------------------------------------------------------------------
def _sabotage_overlap_write(device: str) -> KernelReport:
    """Run K5 once on ``device`` and verify the launch it recorded: its
    output map ``(i, j - j % 2)`` writes block columns 0 and 2 twice and 1
    and 3 never, an overlap and a gap."""
    from repro_torch.kernels.sabotage import sabotage_overlap_matmul

    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 16), generator=gen).to(device)
    w = torch.randn((16, 32), generator=gen).to(device)
    before = collections.Counter(launch.RECORDED)
    sabotage_overlap_matmul(x, w)
    return verify_specs("sabotage:overlap_write",
                        recorded_specs(collections.Counter(launch.RECORDED) - before))


def _sabotage_deep_k(device: str) -> KernelReport:
    """K3's launch at <2,4> x k_block 2048: 25 integer bits >= 24.  The raw
    launcher takes it; ``mls_matmul`` and ``QuantConfig`` refuse it, the hole
    this control names."""
    specs = matmul_spec(8, 8, 2048, 2048, "nc", FMT_IMAGENET, device_type=device)
    return verify_specs("sabotage:deep_k", _once(specs))


def _sabotage_drop_halo(device: str) -> KernelReport:
    """K4's window proof with the staged band one row short of its taps
    (the JAX control's geometry: x (2, 4, 8, 8), w (8, 4, 3, 3), SAME, two
    channels per k-block): the proof must name the ``oob``."""
    geom = implicit_conv.conv_geometry((2, 4, 8, 8), (8, 4, 3, 3), (1, 1), "SAME")
    short = int(implicit_conv.band_rows(geom)[1].max()) - 1
    viols, cov = prove_window_grid(geom, 2 * geom.kk, band_rows=short)
    return KernelReport("sabotage:drop_halo", [_window_report("sabotage:drop_halo", viols, cov)])


_SABOTAGE_BUILDERS = {
    "overlap_write": _sabotage_overlap_write,
    "deep_k": _sabotage_deep_k,
    "drop_halo": _sabotage_drop_halo,
}


# the tensor-parallel steps the audit proves K1's split entries and K3 at:
# chatglm3-6b, zamba2-7b, moonshot-v1-16b-a3b and seamless-m4t-medium (its
# cross-attention over 4096 source frames) at a model axis of 2, and yi-34b
# at 16 (56 query heads split 4 / 3: rank 0's wq of 512 columns and wo of 512
# rows, rank 15's of 384), 4096 tokens (batch 1 x 4096, the chip smoke's)
TP_AUDIT = ("chatglm3-6b", 2, 4096)
TP_AUDIT_HYBRID = ("zamba2-7b", 2, 4096)
TP_AUDIT_MOE = ("moonshot-v1-16b-a3b", 2, 4096)
TP_AUDIT_ENCDEC = ("seamless-m4t-medium", 2, 4096)
TP_AUDIT_UNEVEN = ("yi-34b", 16, 4096)
TP_AUDITS = (TP_AUDIT, TP_AUDIT_HYBRID, TP_AUDIT_MOE, TP_AUDIT_ENCDEC, TP_AUDIT_UNEVEN)


def tensor_parallel_specs(cfg, model_axis: int, tokens: int,
                          device: str = "cpu") -> list[tuple[LaunchSpec, int]]:
    """The launches of K1's split entries (pass A, then pass B over the
    all-reduced max) on every sharded GEMM operand of one layer's linears
    in a tensor-parallel training step of ``cfg`` (the quantized backend's
    padded 2-D operands, ``tokens`` rows of activations, the encoder's
    output too), and of K3 on each such linear's three GEMMs (forward,
    data and weight gradient), on the first and the last rank of the
    model axis (the uneven splits differ, and the first holds a Mamba2
    in_proj's tail), with the tile cache's choices; the hybrid's shared
    block and the encoder's first layer too.  The routed experts reach no
    kernel."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.lowbit_conv import _gemm_plan
    from repro_torch.launch.specs import abstract_params
    from repro_torch.parallel.tensor import tp_layout

    qcfg = dataclasses.replace(cfg, quant_backend="pallas").qcfg()
    kb, fmt = qcfg.k_block, qcfg.fmt
    full = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    layout = tp_layout(cfg, full, model_axis)

    def pad(n: int) -> int:
        return -(-n // kb) * kb

    shapes, gemms = collections.Counter(), collections.Counter()
    for name, sp in layout.items():
        if (not name.startswith(("layers.0.", "enc_layers.0.", "shared_attn."))
                or not name.endswith(".w")):
            continue
        d_in, d_out = full[name]
        for n in {sp.size(0), sp.size(len(sp.pieces) - 1)}:
            if sp.dim == 1:  # column-parallel: w^T, the error and its transpose
                shapes.update([(n, pad(d_in)), (tokens, pad(n)), (d_in, pad(n)),
                               (n, pad(tokens))])
                gemms.update([(tokens, d_in, n), (tokens, n, d_in), (d_in, tokens, n)])
            else:  # row-parallel: x, w^T, w and x^T
                shapes.update([(tokens, pad(n)), (d_out, pad(n)), (n, pad(d_out)),
                               (n, pad(tokens))])
                gemms.update([(tokens, n, d_out), (tokens, d_out, n), (n, tokens, d_out)])
    specs = collections.Counter()
    for (m, k, n), c in gemms.items():  # (M, K, N) of x (M, K) @ w (K, N)
        specs[("mls_matmul", device, m, n, pad(k), kb, "nc", fmt,
               _gemm_plan(m, k, n, fmt, kb, "nc", device))] += c
    for (rows, cols), k in shapes.items():
        config = autotune.resolve_block_config("quantize", (rows, cols), fmt, "nc",
                                               k_block=kb, device=device)
        _, (_, _, width, variant, parts) = quantize_launch(rows, cols, kb, "nc", config)
        specs.update({(("mls_quantize_rows_amax", device, rows * cols, parts)): k,
                      (("mls_quantize_rows_codes", device, rows, cols, width, variant, 1)): k})
    return recorded_specs(specs)


# the LM training step the audit proves K1 and K3 at: chatglm3-6b's
# forward, data-gradient and weight-gradient GEMMs at 8192 tokens (the
# seed tile cache's T), where K3 runs its wgmma variant
LM_AUDIT = ("chatglm3-6b", 8192)


def lm_train_specs(cfg, tokens: int, device: str = "cpu") -> list[tuple[LaunchSpec, int]]:
    """The launches of one training step's quantized GEMMs of ``cfg``
    (one of each distinct linear): K3 on the forward (tokens, K) @ (K, N),
    the data gradient (tokens, N) @ (N, K) and the weight gradient (K,
    tokens) @ (tokens, N), with the tile cache's choices (``qd_gemm``'s),
    and K1 on both padded operands of each."""
    from repro_torch.kernels import autotune
    from repro_torch.kernels.lowbit_conv import _gemm_plan

    qcfg = dataclasses.replace(cfg, quant_backend="pallas").qcfg()
    kb, fmt = qcfg.k_block, qcfg.fmt
    specs = collections.Counter()
    quantized = []
    for k_in, n_out in autotune._lm_linears(cfg.name):
        for m, k, n in ((tokens, k_in, n_out), (tokens, n_out, k_in), (k_in, tokens, n_out)):
            kp = -(-k // kb) * kb
            specs[("mls_matmul", device, m, n, kp, kb, "nc", fmt,
                   _gemm_plan(m, k, n, fmt, kb, "nc", device))] += 1
            quantized += [(m, kp), (n, kp)]
    out = recorded_specs(specs)
    for rows, cols in dict.fromkeys(quantized):
        out += _quantize_specs(rows, cols, kb, "nc", device)
    return out


def run_kernel_audit(sabotage: str | None = None, device: str = "cuda",
                     recorded: dict[str, list[tuple[LaunchSpec, int]]] | None = None) -> dict:
    """Verify every ``KERNEL_REGISTRY`` entry on ``device``, the launches
    ``recorded`` by named graphs, and an optional planted negative control;
    return the ``--kernels`` report section."""
    from repro_torch.kernels.registry import KERNEL_REGISTRY

    reports = {name: verify_entry(entry, device) for name, entry in KERNEL_REGISTRY.items()}
    from repro_torch.configs import get_config

    for arch, m, tokens in TP_AUDITS:
        reports[f"tensor_parallel:{arch}@model{m}"] = verify_specs(
            f"tensor_parallel:{arch}@model{m}",
            tensor_parallel_specs(get_config(arch), m, tokens, device))
    arch, tokens = LM_AUDIT
    reports[f"lm_train:{arch}@{tokens}"] = verify_specs(
        f"lm_train:{arch}@{tokens}", lm_train_specs(get_config(arch), tokens, device))
    for name, specs in (recorded or {}).items():
        reports[name] = verify_specs(name, specs)
    if sabotage is not None:
        reports[f"sabotage:{sabotage}"] = _SABOTAGE_BUILDERS[sabotage](device)
    return {
        "budget_bits": ACC_BUDGET_BITS,
        "ok": all(r.ok for r in reports.values()),
        "distinct_launch_specs": sum(len(r.calls) for r in reports.values()),
        "kernels": {name: r.to_json() for name, r in reports.items()},
    }
