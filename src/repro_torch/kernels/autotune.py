"""Shape-keyed tile cache of the port's kernels, and the tuner that fills it.

The counterpart of the JAX package's ``repro.kernels.autotune``, with the
same names, cache keys and CLI.  A *tuning key* is ``(kind, shape, <E,M>
format, grouping)``, letter for letter JAX's (:meth:`TuneSpec.key`); its
winner is a :class:`BlockConfig`, the port's own:

* ``"gemm"`` (K3, shape (M, K, N), K the logical contraction before
  ``qd_gemm`` pads it): ``variant`` ``"walk"`` or ``"split"`` (the ordered
  split) and ``bn``, the tile's N extent (16, 32, 64), or ``"wgmma"``
  (Hopper's int8 ``wgmma`` on 128 x 128 tiles, ``bn`` 128);
* ``"quantize"`` (shape (M, K), the operand ``mls_quantize`` receives):
  for groupings "nc"/"n" (K1) ``variant`` ``"warp"`` (a warp per group,
  widths up to ``kWarpGroupMax``) or ``"block"`` (a block per group) and
  ``amax_blocks``, pass A's grid; for "c"/"none" (K2) ``"cols"``, the one
  choice;
* ``"conv"`` (shape: the 13 geometry dims of ``ConvGeom.as_dims()`` and
  ``k_block``): ``variant`` ``"im2col"`` or ``"implicit"`` (K4) and, for
  K4, ``bn``.

**The tuner picks only between choices that give the same bits.**  Every
candidate of a key computes the same codes, scales and outputs (max is
exact in any order; K3's walk and ordered split add the group terms in k
order alike, and so does the wgmma variant; the conv's two lowerings
share codes and GEMM).  ``k_block``,
the grouping, the format, the rounding bytes and K3's body (int8 iff
``fmt.max_fraction <= 127``) are never tuned.  This is where the port
departs from JAX: its ``gemm_candidates`` also searches neighbouring
``k_block`` widths, which changes the scaling groups.

* **Candidates** (:func:`gemm_candidates`, :func:`quantize_candidates`,
  :func:`conv_candidates`) list only what is legal and exact, the shipped
  default (:func:`default_block_config`, today's fixed rule) always
  among them, so a tuned winner never loses to it.
* **Pruning**: every candidate is proven by the port's static verifier
  (:func:`verify_config`: ``analysis.kernel_verify``'s
  ``verify_candidate``, ``verify_quantize_candidate`` and
  ``verify_implicit_conv_candidate`` with the config's launches) before it
  is timed.
* **Timing** (:func:`time_config`): CUDA events, median of ``n`` calls
  after warm-ups, on operands on the card, of the call the choice
  affects, with the host run ahead of the card (:func:`device_ms`): the
  choice moves device time; the wrapper's host time, the same for every
  choice, would otherwise set small calls' times and pick on noise.
* **Persistence**: winners land in a JSON cache that records the card it
  was tuned on (``device``: ``torch.cuda.get_device_name()``).  The
  local overlay (``$REPRO_TORCH_TUNE_CACHE`` or
  ``.cache/kernel_tune_torch.json``) is merged over the committed seed
  cache (``kernels/tuned/kernel_tune.json``, tuned on an H100).

Hot-path resolution (:func:`resolve_block_config`) never times or proves:
**explicit > cache hit for this device > default**, memoized on its key.
A cache made on another device, or on the CPU, is ignored for resolution
(with a load warning), so CPU runs keep the defaults.  A call planned for
a card by name (``card``: a fake operand's, the dry run's) resolves
through the committed seed cache alone, on any device:
:func:`modelled_card` is the card that cache was tuned on.  There is no
fallback: a cached config that cannot launch makes the call raise.

CLI::

    python -m repro_torch.kernels.autotune --check              # static proofs
    python -m repro_torch.kernels.autotune --tune [--force]     # on the card
        [--cache PATH] [--specs registry|path|all] [--kind gemm|quantize|conv]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import statistics
import sys
import time
from collections.abc import Callable, Iterable

from repro_torch.core.formats import EMFormat

__all__ = [
    "BNS",
    "AMAX_BLOCKS",
    "BlockConfig",
    "TuneSpec",
    "TuneCache",
    "CACHE_ENV_VAR",
    "CACHE_SCHEMA_VERSION",
    "DEFAULT_CACHE_PATH",
    "SEED_CACHE_PATH",
    "cache_key",
    "candidates_for",
    "check_cache",
    "conv_candidates",
    "cuda_ms",
    "default_block_config",
    "device_ms",
    "device_name",
    "gemm_candidates",
    "get_cache",
    "invalidate_cache",
    "modelled_card",
    "override_cache",
    "path_specs",
    "quantize_candidates",
    "registry_specs",
    "resolve_block_config",
    "seed_cache",
    "time_config",
    "tune",
    "tune_all",
    "tune_spec",
    "verify_config",
]

CACHE_SCHEMA_VERSION = 1
CACHE_ENV_VAR = "REPRO_TORCH_TUNE_CACHE"
DEFAULT_CACHE_PATH = pathlib.Path(".cache") / "kernel_tune_torch.json"
SEED_CACHE_PATH = pathlib.Path(__file__).parent / "tuned" / "kernel_tune.json"

BNS = (16, 32, 64)  # K3's and K4's tile widths (their template instances)
WGMMA_BN = 128  # K3's wgmma variant's one tile width (mls_matmul.WGMMA_BN)
AMAX_BLOCKS = (66, 132, 264)  # K1 pass-A grids tried (1/2, 1, 2 blocks per SM)
VARIANTS = {"gemm": ("walk", "split", "wgmma"), "quantize": ("warp", "block", "cols"),
            "conv": ("im2col", "implicit")}
_SHAPE_RANK = {"gemm": 3, "quantize": 2, "conv": 14}


# ---------------------------------------------------------------------------
# BlockConfig / TuneSpec
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class BlockConfig:
    """One launch choice of a kernel call (see the module docstring).

    ``bn`` is 0 where no tile width applies (K1/K2, im2col), ``WGMMA_BN``
    for K3's wgmma variant, and ``amax_blocks`` 0 where no pass-A grid
    does (K2, K3, the conv)."""

    variant: str
    bn: int = 0
    amax_blocks: int = 0

    def __post_init__(self):
        if not any(self.variant in v for v in VARIANTS.values()):
            raise ValueError(f"unknown variant {self.variant!r}")
        if self.bn not in (0, *BNS) and (self.variant, self.bn) != ("wgmma", WGMMA_BN):
            raise ValueError(f"bn={self.bn} is not 0 or one of {BNS} ({WGMMA_BN} for wgmma)")
        if self.amax_blocks < 0:
            raise ValueError(f"amax_blocks={self.amax_blocks} < 0")

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, d: dict) -> BlockConfig:
        if not isinstance(d, dict) or not isinstance(d.get("variant"), str):
            raise ValueError(f"not a BlockConfig: {d!r}")
        return cls(variant=d["variant"], bn=int(d.get("bn", 0)),
                   amax_blocks=int(d.get("amax_blocks", 0)))

    def replace(self, **kw) -> BlockConfig:
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TuneSpec:
    """One tunable workload: ``kind`` ``"gemm"`` (shape (M, K, N)),
    ``"quantize"`` ((M, K)) or ``"conv"`` (the 13 geometry dims of
    ``implicit_conv.ConvGeom.as_dims()`` followed by ``k_block``), at one
    format, group width ``k_block`` and grouping."""

    kind: str
    shape: tuple[int, ...]
    fmt: EMFormat
    k_block: int = 128
    grouping: str = "nc"

    def __post_init__(self):
        if self.kind not in _SHAPE_RANK:
            raise ValueError(f"unknown TuneSpec kind {self.kind!r}")
        if len(self.shape) != _SHAPE_RANK[self.kind]:
            raise ValueError(f"{self.kind} TuneSpec needs a rank-{_SHAPE_RANK[self.kind]} "
                             f"shape, got {self.shape}")
        if self.kind == "conv" and self.shape[13] != self.k_block:
            raise ValueError(f"conv TuneSpec shape[13] must equal k_block, got "
                             f"{self.shape[13]} != {self.k_block}")

    def key(self) -> str:
        """The cache key ``kind:dims:eEmM:grouping``, as the JAX package's."""
        return cache_key(self.kind, self.shape, self.fmt, self.grouping)

    def to_json(self) -> dict:
        return {"kind": self.kind, "shape": list(self.shape), "fmt": [self.fmt.e, self.fmt.m],
                "k_block": self.k_block, "grouping": self.grouping}

    @classmethod
    def from_json(cls, d: dict) -> TuneSpec:
        e, m = d["fmt"]
        return cls(kind=str(d["kind"]), shape=tuple(int(s) for s in d["shape"]),
                   fmt=EMFormat(int(e), int(m)), k_block=int(d.get("k_block", 128)),
                   grouping=str(d.get("grouping", "nc")))


def tune_spec(kind: str, shape: Iterable[int], fmt: EMFormat, k_block: int = 128,
              grouping: str = "nc") -> TuneSpec:
    return TuneSpec(kind, tuple(int(s) for s in shape), fmt, k_block, grouping)


def cache_key(kind: str, shape: Iterable[int], fmt: EMFormat, grouping: str) -> str:
    dims = "x".join(str(int(d)) for d in shape)
    return f"{kind}:{dims}:e{fmt.e}m{fmt.m}:{grouping}"


def _check_kind(spec: TuneSpec, config: BlockConfig) -> None:
    if config.variant not in VARIANTS[spec.kind]:
        raise ValueError(f"variant {config.variant!r} is not a {spec.kind} choice")


# ---------------------------------------------------------------------------
# Persistent cache
# ---------------------------------------------------------------------------
class TuneCache:
    """JSON-backed map ``key -> (BlockConfig winner, timing metadata)``, for
    the card named ``device``.

    A corrupt file, a wrong ``version`` or a malformed entry gives an empty
    cache (or drops the entry) plus a ``load_warnings`` line, never a
    crash."""

    def __init__(self, path: str | os.PathLike | None = None, device: str | None = None):
        self.path = pathlib.Path(path) if path is not None else None
        self.device = device
        self.entries: dict[str, dict] = {}
        self.load_warnings: list[str] = []

    @classmethod
    def load(cls, path: str | os.PathLike) -> TuneCache:
        cache = cls(path)
        p = pathlib.Path(path)
        if not p.exists():
            return cache
        try:
            payload = json.loads(p.read_text())
        except (json.JSONDecodeError, OSError, UnicodeDecodeError) as e:
            cache.load_warnings.append(f"{p}: unreadable tuning cache ({e})")
            return cache
        version = payload.get("version") if isinstance(payload, dict) else "?"
        if version != CACHE_SCHEMA_VERSION:
            cache.load_warnings.append(f"{p}: tuning-cache schema {version} != "
                                       f"{CACHE_SCHEMA_VERSION}; ignoring stale cache")
            return cache
        entries, device = payload.get("entries", {}), payload.get("device")
        if not isinstance(entries, dict) or not (device is None or isinstance(device, str)):
            cache.load_warnings.append(f"{p}: malformed 'entries' or 'device'; ignoring")
            return cache
        cache.device = device
        for key, ent in entries.items():
            try:
                spec = TuneSpec.from_json(ent)
                _check_kind(spec, BlockConfig.from_json(ent["config"]))
                if spec.key() != key:
                    raise ValueError(f"its spec keys as {spec.key()!r}")
                cache.entries[str(key)] = ent
            except (KeyError, TypeError, ValueError) as e:
                cache.load_warnings.append(f"{p}: dropping malformed entry {key!r} ({e})")
        return cache

    def save(self, path: str | os.PathLike | None = None) -> pathlib.Path:
        p = pathlib.Path(path) if path is not None else self.path
        if p is None:
            raise ValueError("TuneCache.save: no path")
        p.parent.mkdir(parents=True, exist_ok=True)
        payload = {"version": CACHE_SCHEMA_VERSION, "device": self.device,
                   "generated_unix": round(time.time(), 1),
                   "entries": {k: self.entries[k] for k in sorted(self.entries)}}
        p.write_text(json.dumps(payload, indent=1) + "\n")
        return p

    def get(self, key: str, k_block: int | None = None) -> BlockConfig | None:
        """The winner under ``key`` (tuned at ``k_block``, when given: the
        key, JAX's, leaves the group width out)."""
        ent = self.entries.get(key)
        if not ent or (k_block is not None and ent.get("k_block", 128) != k_block):
            return None
        return BlockConfig.from_json(ent["config"])

    def put(self, spec: TuneSpec, config: BlockConfig, ms: float, timed: int = 0,
            pruned: int = 0, source: str = "autotune") -> None:
        _check_kind(spec, config)
        self.entries[spec.key()] = {**spec.to_json(), "config": config.to_json(),
                                    "ms": float(ms), "candidates_timed": int(timed),
                                    "candidates_pruned": int(pruned), "source": source}

    def merged_over(self, base: TuneCache) -> TuneCache:
        """This cache's entries overlaid on ``base`` (self wins)."""
        out = TuneCache(self.path, self.device or base.device)
        out.entries = {**base.entries, **self.entries}
        out.load_warnings = base.load_warnings + self.load_warnings
        return out

    def __len__(self) -> int:
        return len(self.entries)


@functools.lru_cache(maxsize=16)
def _cuda_name(index: int) -> str:
    import torch

    return torch.cuda.get_device_name(index)


def device_name(device=None) -> str:
    """The name a cache is keyed to for a call on ``device`` (a torch device
    or its string): ``"cpu"`` on the CPU, else the card's name; ``None``:
    the process's default device (the first card if there is one)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return _cuda_name(device.index if device.index is not None else torch.cuda.current_device())


_CACHE: TuneCache | None = None
_RESOLVED: dict[tuple, BlockConfig] = {}


def get_cache() -> TuneCache:
    """The process-wide resolution cache, loaded once: the local cache
    (``$REPRO_TORCH_TUNE_CACHE`` or ``.cache/kernel_tune_torch.json``)
    merged over the committed seed cache, each kept only when it was tuned
    on this process's device (:func:`device_name`)."""
    global _CACHE
    if _CACHE is None:
        here = device_name()
        merged = TuneCache(device=here)
        for path in (SEED_CACHE_PATH, os.environ.get(CACHE_ENV_VAR, DEFAULT_CACHE_PATH)):
            c = TuneCache.load(path)
            if c.entries and (c.device != here or here == "cpu"):
                c.load_warnings.append(f"{path}: tuned on {c.device!r}, this process runs on "
                                       f"{here!r}; ignored for resolution")
                c.entries = {}
            merged = c.merged_over(merged)
            merged.device = here
        _CACHE = merged
    return _CACHE


@functools.lru_cache(maxsize=1)
def seed_cache() -> TuneCache:
    """The committed seed cache alone, loaded once (the cache a call
    planned for :func:`modelled_card` resolves through)."""
    return TuneCache.load(SEED_CACHE_PATH)


def modelled_card() -> str:
    """The card a fake operand stands for: the one the seed cache was tuned
    on (an H100), whatever device the trace runs on."""
    return seed_cache().device


def invalidate_cache() -> None:
    """Drop the memoized resolution cache and resolutions (tests / after
    re-tuning)."""
    global _CACHE
    _CACHE = None
    _RESOLVED.clear()


@contextlib.contextmanager
def override_cache(cache: TuneCache):
    """``with override_cache(cache):`` resolves through ``cache`` (its
    ``device`` must match the calls' for its entries to apply) instead of
    :func:`get_cache`'s, e.g. to run a step with an empty cache."""
    global _CACHE
    saved = _CACHE, dict(_RESOLVED)
    _CACHE = cache
    _RESOLVED.clear()
    try:
        yield cache
    finally:
        _CACHE = saved[0]
        _RESOLVED.clear()
        _RESOLVED.update(saved[1])


# ---------------------------------------------------------------------------
# Defaults and candidate enumeration
# ---------------------------------------------------------------------------
def _padded_k(K: int, k_block: int) -> int:
    return -(-K // k_block) * k_block


def _geom(spec: TuneSpec):
    from .implicit_conv import ConvGeom

    return ConvGeom(*spec.shape[:13])


def _quantize_width(spec: TuneSpec) -> int:
    return spec.k_block if spec.grouping == "nc" else spec.shape[1]


def default_block_config(spec: TuneSpec) -> BlockConfig:
    """Today's fixed rule: for a gemm, ``matmul_plan``'s variant and ``bn``
    (on K padded to ``k_block``, as ``qd_gemm`` pads it); for a K1
    quantizer, a warp per group iff the group is at most ``kWarpGroupMax``
    wide, and pass A's grid from the operand's size; for K2 ``"cols"``;
    for a conv, implicit where :func:`implicit_conv.resolve_conv_impl`'s
    legality rule allows it (``bn`` the narrowest tile that holds O), else
    im2col."""
    if spec.kind == "gemm":
        from .mls_matmul import matmul_plan

        M, K, N = spec.shape
        plan = matmul_plan(M, N, _padded_k(K, spec.k_block), spec.k_block, spec.fmt)
        return BlockConfig(plan.variant, plan.bn)
    if spec.kind == "quantize":
        from .mls_quantize import TILE, _amax_blocks

        if spec.grouping in ("c", "none"):
            return BlockConfig("cols")
        M, K = spec.shape
        warp = _quantize_width(spec) <= TILE["kWarpGroupMax"]
        return BlockConfig("warp" if warp else "block", 0, _amax_blocks(M * K, TILE))
    from .implicit_conv import default_conv_blocks, implicit_legal

    geom = _geom(spec)
    if implicit_legal(geom, spec.k_block)[0]:
        return BlockConfig("implicit", default_conv_blocks(geom)[1])
    return BlockConfig("im2col")


def _with_default(spec: TuneSpec, cands: list[BlockConfig]) -> list[BlockConfig]:
    default = default_block_config(spec)
    return [default] + [c for c in cands if c != default]


def gemm_candidates(spec: TuneSpec) -> list[BlockConfig]:
    """K3's walk at every tile width up to the default's (wider tiles only
    mask more columns), the ordered split at each where it has 1 to 65535
    groups and its (G, M, N) workspace stays within
    ``mls_matmul.WORKSPACE_LIMIT``, and the wgmma variant where
    ``mls_matmul.tuned_plan`` accepts it."""
    from .mls_matmul import _MAX_GRID_YZ, WORKSPACE_LIMIT, tuned_plan

    M, K, N = spec.shape
    kp = _padded_k(K, spec.k_block)
    groups = kp // spec.k_block
    widest = default_block_config(spec).bn
    bns = [b for b in BNS if b <= widest and -(-N // b) <= _MAX_GRID_YZ]
    split_ok = 1 <= groups <= _MAX_GRID_YZ and groups * M * N * 4 <= WORKSPACE_LIMIT
    cands = [BlockConfig("walk", b) for b in bns]
    cands += [BlockConfig("split", b) for b in bns if split_ok]
    try:
        tuned_plan("wgmma", WGMMA_BN, M, N, kp, spec.k_block, spec.fmt)
        cands.append(BlockConfig("wgmma", WGMMA_BN))
    except ValueError:
        pass
    return _with_default(spec, cands)


def quantize_candidates(spec: TuneSpec) -> list[BlockConfig]:
    """K1 ("nc"/"n"): a warp per group (widths up to ``kWarpGroupMax``) or
    a block per group, each at pass-A grids of ``AMAX_BLOCKS`` capped by
    the operand's ``kAmaxChunk`` chunks; K2 ("c"/"none"): ``"cols"``
    alone."""
    from .mls_quantize import TILE

    if spec.grouping in ("c", "none"):
        return [BlockConfig("cols")]
    M, K = spec.shape
    chunks = max(1, -(-M * K // TILE["kAmaxChunk"]))
    grids = sorted({min(b, chunks) for b in AMAX_BLOCKS})
    variants = ["warp"] if _quantize_width(spec) <= TILE["kWarpGroupMax"] else []
    return _with_default(spec, [BlockConfig(v, 0, a) for v in (*variants, "block")
                                for a in grids])


def conv_candidates(spec: TuneSpec) -> list[BlockConfig]:
    """im2col, plus K4 at every tile width up to the default's where its
    layout is legal for ``k_block`` (:func:`implicit_conv.implicit_compatible`)
    and its halo band fits (:func:`implicit_conv.band_fits`).  ``k_block``
    is held fixed: for a conv it is the scaling-group width."""
    from .implicit_conv import default_conv_blocks, implicit_legal

    geom = _geom(spec)
    cands = [BlockConfig("im2col")]
    if implicit_legal(geom, spec.k_block)[0]:
        widest = default_conv_blocks(geom)[1]
        cands += [BlockConfig("implicit", b) for b in BNS if b <= widest]
    return _with_default(spec, cands)


def candidates_for(spec: TuneSpec) -> list[BlockConfig]:
    if spec.kind == "gemm":
        return gemm_candidates(spec)
    if spec.kind == "conv":
        return conv_candidates(spec)
    return quantize_candidates(spec)


# ---------------------------------------------------------------------------
# Legality oracle (static verifier) and timing
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=4096)
def verify_config(spec: TuneSpec, config: BlockConfig, device: str = "cpu"):
    """Statically prove one candidate's launches (grid coverage, the 2^24
    accumulator budget, K4's window and its shared memory, K3's split
    workspace) without running anything; the tuner's pruning step.
    Returns the verifier's ``KernelReport`` (memoized: treat it as read
    only); ``device`` picks where the launch constants come from ("cuda":
    the built library)."""
    from repro_torch.analysis.kernel_verify import (
        refused,
        verify_candidate,
        verify_implicit_conv_candidate,
        verify_quantize_candidate,
    )

    name = f"{spec.key()} {config}"
    if config.variant not in VARIANTS[spec.kind]:
        return refused(name, f"variant {config.variant!r} is not a {spec.kind} choice")
    if spec.kind == "gemm":
        return verify_candidate(spec.shape, (spec.fmt, spec.k_block), spec.grouping,
                                device=device, config=config)
    if spec.kind == "quantize":
        return verify_quantize_candidate(spec.shape, spec.fmt, spec.k_block,
                                         grouping=spec.grouping, device=device, config=config)
    geom = _geom(spec)
    if config.variant == "implicit":
        return verify_implicit_conv_candidate(geom, spec.fmt, spec.k_block, spec.grouping,
                                              device=device, config=config)
    # im2col lowers to qd_gemm's virtual GEMM at its default launches
    return verify_candidate((geom.m0, geom.k0, geom.o), (spec.fmt, spec.k_block),
                            spec.grouping, device=device)


def cuda_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median ms of ``fn()`` per call by CUDA events around each of ``n``
    calls after ``warmup`` calls, each synchronised: what a caller waits,
    the wrapper's host time included."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


@functools.lru_cache(maxsize=1)
def _sleep_cycles_per_ms() -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(10_000_000)
    end.record()
    end.synchronize()
    return 10_000_000 / start.elapsed_time(end)


def device_ms(fn, n: int = 20, warmup: int = 3) -> float:
    """Median device ms of ``fn()`` per call: CUDA events around each of
    ``n`` calls after ``warmup`` calls, all enqueued while the stream is
    held by a sleep kernel longer than their host time, so each pair of
    events spans the call's device work without the host's gaps.  The
    tuner's timer: a launch choice moves device time, not the wrapper's
    host time, which sets small calls' :func:`cuda_ms`."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    torch.cuda._sleep(int((2 * host_ms + 1) * _sleep_cycles_per_ms()))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def config_call(spec: TuneSpec, config: BlockConfig | None, device="cuda", seed: int = 0):
    """``fn()`` running the call ``config`` steers at ``spec``'s shape on
    operands made from ``seed`` on ``device``: ``mls_matmul`` with the
    config's plan on pre-made codes (gemm), ``mls_quantize`` with the
    config (quantize), or the forward of ``lowbit_conv_fused`` resolving
    through a cache that holds only this config (conv), rounding to
    nearest.  ``config`` None: the plain PyTorch version of the same call
    on the same operands."""
    import torch

    from repro_torch.core.formats import GS_FMT_DEFAULT

    from . import ref
    from .mls_quantize import mls_quantize, rounding_bytes

    gen = torch.Generator(device=device).manual_seed(seed)
    fmt, kb, grouping = spec.fmt, spec.k_block, spec.grouping
    if spec.kind == "gemm":
        from .mls_matmul import mls_matmul, tuned_plan

        M, K, N = spec.shape
        kp = _padded_k(K, kb)
        x = torch.zeros((M, kp), device=device)
        x[:, :K] = torch.randn((M, K), generator=gen, device=device)
        wt = torch.zeros((N, kp), device=device)
        wt[:, :K] = torch.randn((N, K), generator=gen, device=device)
        xc, xsg, xst = mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, None, grouping)
        wc, wsg, wst = mls_quantize(wt, fmt, kb, GS_FMT_DEFAULT, None, grouping)
        del x, wt
        if config is None:
            return lambda: ref.mls_matmul_ref(xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        plan = tuned_plan(config.variant, config.bn, M, N, kp, kb, fmt)
        return lambda: mls_matmul(xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb, grouping,
                                  plan=plan)
    if spec.kind == "quantize":
        x = torch.randn(spec.shape, generator=gen, device=device)
        r = rounding_bytes(spec.shape, gen, torch.device(device))
        if config is None:
            return lambda: ref.quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, r, grouping)
        return lambda: mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, r, grouping, config=config)
    from repro_torch.core.lowbit import QuantConfig

    from .lowbit_conv import lowbit_conv_fused

    geom = _geom(spec)
    x = torch.randn((geom.n, geom.c, geom.h, geom.w), generator=gen, device=device)
    w = torch.randn((geom.o, geom.c, geom.kh, geom.kw), generator=gen, device=device) * 0.1
    if config is None:
        rx = rounding_bytes((geom.m0, geom.k0), None, torch.device(device))
        rw = rounding_bytes((geom.o, geom.k0), None, torch.device(device))
        return lambda: ref.implicit_conv_ref(x, w, rx, rw, (geom.sh, geom.sw), geom.pads,
                                             fmt=fmt, gs_fmt=GS_FMT_DEFAULT, k_block=kb,
                                             grouping=grouping)
    cfg = QuantConfig(fmt=fmt, k_block=kb, grouping=grouping, stochastic=False)
    only = TuneCache(device=device_name(device))
    only.put(spec, config, 0.0)

    def conv():
        with override_cache(only):
            return lowbit_conv_fused(x, w, None, (geom.sh, geom.sw), geom.pads, cfg)
    return conv


def time_config(spec: TuneSpec, config: BlockConfig, n: int = 20, warmup: int = 3) -> float:
    """Median device ms on the card of the call ``config`` steers at
    ``spec``'s shape (:func:`config_call`), by CUDA events
    (:func:`device_ms`)."""
    return device_ms(config_call(spec, config), n, warmup)


# ---------------------------------------------------------------------------
# Tuning
# ---------------------------------------------------------------------------
def tune(spec: TuneSpec, cache: TuneCache,
         timer: Callable[[TuneSpec, BlockConfig], float] | None = None, force: bool = False,
         log: Callable[[str], None] | None = None, device: str = "cpu") -> BlockConfig:
    """Tune one spec: a cache hit short-circuits (no timing) unless
    ``force``; otherwise enumerate -> prove with the static verifier (launch
    constants from ``device``) -> time the survivors -> keep the fastest
    in ``cache``.  ``timer`` (default :func:`time_config`) is injectable."""
    key = spec.key()
    if not force:
        hit = cache.get(key)
        if hit is not None:
            return hit
    timer = timer or time_config
    say = log or (lambda _m: None)
    timed = pruned = 0
    best: tuple[float, BlockConfig] | None = None
    for config in candidates_for(spec):
        report = verify_config(spec, config, device)
        if not report.ok:
            pruned += 1
            say(f"  pruned {config} ({report.first_violation()})")
            continue
        ms = timer(spec, config)
        timed += 1
        say(f"  {config}: {ms:.4f} ms")
        if best is None or ms < best[0]:
            best = (ms, config)
    if best is None:
        raise RuntimeError(f"no legal candidate for {key}")
    cache.put(spec, best[1], best[0], timed=timed, pruned=pruned)
    return best[1]


def registry_specs() -> list[TuneSpec]:
    """The tuning specs declared by ``KERNEL_REGISTRY`` entries (JAX's)."""
    from .registry import KERNEL_REGISTRY

    return [e.tune for e in KERNEL_REGISTRY.values() if e.tune is not None]


def _gemm_and_operands(M: int, K: int, N: int, fmt: EMFormat, kb: int,
                       grouping: str) -> list[TuneSpec]:
    """``qd_gemm``'s calls on an (M, K) @ (K, N) GEMM: K3 on the logical
    shape, then the quantizer on x (M, Kp) and on the transposed weight
    (N, Kp)."""
    kp = _padded_k(K, kb)
    return [TuneSpec("gemm", (M, K, N), fmt, kb, grouping),
            TuneSpec("quantize", (M, kp), fmt, kb, grouping),
            TuneSpec("quantize", (N, kp), fmt, kb, grouping)]


def _lm_linears(name: str, keep=lambda mname: True) -> list[tuple[int, int]]:
    """The (K, N) of every quantized linear of config ``name`` built on the
    meta device (the LM head, the frontend projection and the MoE router
    are not quantized)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import nn as L
    from repro_torch.models.lm import LM

    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", n_layers=1)
    with torch.device("meta"):
        model = LM(cfg)
    out = []
    for mname, mod in model.named_modules():
        if (isinstance(mod, L.Linear) and mname != "frontend_proj"
                and not mname.endswith("router") and keep(mname)):
            if tuple(mod.w.shape) not in out:
                out.append(tuple(mod.w.shape))
    return out


PATH_BATCH, PATH_HW, PATH_K_BLOCK, PATH_K_BLOCK_IMPLICIT = 128, 32, 128, 144
LM_DECODE_BATCH, LM_TRAIN_TOKENS = 4, 8192


def path_specs() -> list[TuneSpec]:
    """The shapes the port runs on the card (<2,4>): every K1/K2/K3 call of a
    full-width ResNet-20 training step at batch 128 and ``k_block`` 128
    (forward, weight and data gradient of its 20 quantized convs, for
    groupings "nc" and "c"); its 18 3x3 convs at ``k_block`` 144 ("nc");
    chatglm3-6b's decode GEMMs at batch 4 and its training GEMMs at T 8192
    (the 8-layer cut's, whose linears are every layer's); llama4-scout's
    shared-expert decode GEMMs.  Read from the conv geometries
    (``models.cnn.quantized_convs``) and the configs, on the meta
    device."""
    from repro_torch.core.formats import FMT_IMAGENET as F
    from repro_torch.models.cnn import CNNConfig, quantized_convs

    from .implicit_conv import conv_tune_dims

    specs: list[TuneSpec] = []

    def add(new):
        specs.extend(s for s in new if s not in specs)

    convs = quantized_convs(CNNConfig("resnet20", 10, 1.0, PATH_HW), PATH_BATCH)
    for grouping in ("nc", "c"):
        for g in convs:
            for M, K, N in ((g.m0, g.k0, g.o), (g.k0, g.m0, g.o), (g.m0, g.o, g.k0)):
                add(_gemm_and_operands(M, K, N, F, PATH_K_BLOCK, grouping))
    add(TuneSpec("conv", conv_tune_dims(g, PATH_K_BLOCK_IMPLICIT), F, PATH_K_BLOCK_IMPLICIT)
        for g in convs if g.kh == 3)
    for K, N in _lm_linears("chatglm3-6b"):
        add(_gemm_and_operands(LM_DECODE_BATCH, K, N, F, 128, "nc"))
        T = LM_TRAIN_TOKENS
        for M, KK, NN in ((T, K, N), (T, N, K), (K, T, N)):
            add(_gemm_and_operands(M, KK, NN, F, 128, "nc"))
    for K, N in _lm_linears("llama4-scout-17b-a16e", lambda m: ".shared." in m):
        add(_gemm_and_operands(LM_DECODE_BATCH, K, N, F, 128, "nc"))
    return specs


def specs_named(which: str) -> list[TuneSpec]:
    """``"registry"``, ``"path"`` or ``"all"`` (registry first, no key twice)."""
    if which not in ("registry", "path", "all"):
        raise ValueError(f"--specs {which!r}: expected registry, path or all")
    specs = registry_specs() if which != "path" else []
    if which != "registry":
        keys = {s.key() for s in specs}
        specs += [s for s in path_specs() if s.key() not in keys]
    return specs


def tune_all(cache: TuneCache, specs: Iterable[TuneSpec] | None = None,
             timer: Callable[[TuneSpec, BlockConfig], float] | None = None,
             force: bool = False, log: Callable[[str], None] | None = None,
             device: str = "cpu") -> dict[str, BlockConfig]:
    say = log or (lambda _m: None)
    out = {}
    for spec in specs if specs is not None else registry_specs():
        say(f"tuning {spec.key()}")
        out[spec.key()] = tune(spec, cache, timer=timer, force=force, log=log, device=device)
    return out


# ---------------------------------------------------------------------------
# Staleness check (--check; also the audit's tune-cache gate)
# ---------------------------------------------------------------------------
def check_cache(cache: TuneCache, specs: Iterable[TuneSpec] | None = None,
                device: str = "cpu") -> dict:
    """Prove the cache fresh: every required spec (default: the registry's)
    has an entry, and every cached winner is a candidate of its spec and
    still passes the static verifier.  Returns a report with ``ok`` and
    the ``failures``, each naming its cause."""
    failures: list[str] = []
    specs = list(specs) if specs is not None else registry_specs()
    for spec in specs:
        if cache.get(spec.key()) is None:
            failures.append(f"required spec {spec.key()} has no tuning-cache entry "
                            f"(run: python -m repro_torch.kernels.autotune --tune)")
    checked = 0
    for key, ent in sorted(cache.entries.items()):
        try:
            spec = TuneSpec.from_json(ent)
            config = BlockConfig.from_json(ent["config"])
        except (KeyError, TypeError, ValueError) as e:
            failures.append(f"cache entry {key}: malformed ({e})")
            continue
        checked += 1
        report = verify_config(spec, config, device)
        if not report.ok:
            failures.append(f"cache entry {key}: winner {config} does not verify "
                            f"({report.first_violation()})")
        elif config not in candidates_for(spec):
            failures.append(f"cache entry {key}: winner {config} is not a candidate of "
                            f"its spec")
    return {"ok": not failures, "device": cache.device, "entries": len(cache),
            "verified": checked, "required_specs": [s.key() for s in specs],
            "load_warnings": cache.load_warnings, "failures": failures}


# ---------------------------------------------------------------------------
# Hot-path resolution: explicit > cache hit for this device > default
# ---------------------------------------------------------------------------
def resolve_block_config(kind: str, shape: tuple[int, ...], fmt: EMFormat,
                         grouping: str = "nc", *, k_block: int, cache: TuneCache | None = None,
                         device=None, card: str | None = None, **explicit) -> BlockConfig:
    """The launch choice of one kernel call: a pure lookup, never timed or
    proven.  Field by field, an explicit non-``None`` ``variant`` / ``bn``
    / ``amax_blocks`` overrides the cached winner, which (when ``cache``,
    default :func:`get_cache`, was tuned on ``device``'s card, see
    :func:`device_name`; never on the CPU; and tuned at this
    ``k_block``) overrides :func:`default_block_config`.  ``card``: plan
    for that card by name instead of ``device``'s, through
    :func:`seed_cache` unless ``cache`` is given.  Memoized on the call's
    key while the process-wide cache is used."""
    over = tuple(sorted((k, v) for k, v in explicit.items() if v is not None))
    if any(k not in ("variant", "bn", "amax_blocks") for k, _ in over):
        raise TypeError(f"unknown BlockConfig field in {explicit}")
    here = card or device_name(device)
    memo = (kind, tuple(shape), fmt, grouping, k_block, here, card is not None, over)
    if cache is None:
        hit = _RESOLVED.get(memo)
        if hit is not None:
            return hit
    c = cache if cache is not None else seed_cache() if card else get_cache()
    config = (c.get(cache_key(kind, shape, fmt, grouping), k_block)
              if here != "cpu" and c.device == here else None)
    if config is None:
        config = default_block_config(TuneSpec(kind, tuple(shape), fmt, k_block, grouping))
    if over:
        config = config.replace(**dict(over))
    if cache is None:
        _RESOLVED[memo] = config
    return config


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels.autotune",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tune", action="store_true",
                    help="prove, time and keep the fastest candidate of each spec (on the card)")
    ap.add_argument("--check", action="store_true",
                    help="every required spec cached and every cached winner still proves "
                         "legal; exit 1 otherwise")
    ap.add_argument("--cache", default=None, metavar="PATH",
                    help=f"cache file (default: the committed seed for --check; "
                         f"${CACHE_ENV_VAR} or {DEFAULT_CACHE_PATH} for --tune)")
    ap.add_argument("--force", action="store_true", help="re-time even on a cache hit")
    ap.add_argument("--specs", default="all", choices=["registry", "path", "all"],
                    help="which specs to tune / require (default all)")
    ap.add_argument("--kind", default=None, choices=sorted(_SHAPE_RANK),
                    help="tune only the specs of this kind (the others keep their entries)")
    args = ap.parse_args(argv)
    if not (args.tune or args.check):
        ap.error("pick --tune and/or --check")
    specs = specs_named(args.specs)

    rc = 0
    if args.tune:
        import torch

        if not torch.cuda.is_available():
            print("--tune times the kernels on the card: no CUDA device", file=sys.stderr)
            return 2
        path = args.cache or os.environ.get(CACHE_ENV_VAR, DEFAULT_CACHE_PATH)
        cache = TuneCache.load(path)
        for w in cache.load_warnings:
            print(f"warning: {w}", file=sys.stderr)
        here = device_name("cuda")
        if cache.entries and cache.device != here:
            print(f"warning: {path} was tuned on {cache.device!r}; re-tuning on {here!r}",
                  file=sys.stderr)
            cache.entries = {}
        cache.device = here
        tuned = [s for s in specs if args.kind in (None, s.kind)]
        winners = tune_all(cache, tuned, force=args.force, log=print, device="cuda")
        out = cache.save(path)
        print(f"tuned {len(winners)} spec(s) on {here} -> {out}")

    if args.check:
        path = args.cache or SEED_CACHE_PATH
        cache = TuneCache.load(path)
        import torch

        report = check_cache(cache, specs, "cuda" if torch.cuda.is_available() else "cpu")
        for w in report["load_warnings"]:
            print(f"warning: {w}", file=sys.stderr)
        print(f"checked {report['verified']} cached winner(s) in {path} (tuned on "
              f"{report['device']}); {len(report['required_specs'])} spec(s) required")
        if not report["ok"]:
            print("TUNING-CACHE CHECK FAILURES:", file=sys.stderr)
            for f in report["failures"]:
                print(f"  - {f}", file=sys.stderr)
            rc = 1
        else:
            print("tuning cache: OK")
    return rc


if __name__ == "__main__":
    # ``python -m`` runs a second copy of this module as __main__; the
    # wrappers resolve through the package's copy, whose cache
    # ``override_cache`` must set while a conv candidate is timed
    from repro_torch.kernels import autotune

    sys.exit(autotune.main())
