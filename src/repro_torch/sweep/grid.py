"""Declarative sweep grid: cells, expansion, dedup and stable config hashes.

The port's copy of the JAX package's ``sweep/grid.py``: the same
:class:`Cell` fields, defaults and hash domain, and the same two committed
grids, so that every cell of ``smoke_grid()`` and ``full_grid()`` has the
same ``cell_id`` and ``config_hash`` in both packages.  A cell's backend
keeps the JAX names: ``"fake_quant"``, and ``"pallas"`` for the
quantized-domain kernels, which the runner maps to the port's
``QuantConfig(backend="quantized")`` (K1/K2/K3 on the card).

A :class:`Cell` is one point on the accuracy/bit-width frontier: an
architecture trained for a few steps under one ``(<E,M> format, grouping,
backend)`` numerics choice.  Grids are written as *spec blocks* -- dicts
whose list-valued axes are expanded as a cartesian product::

    {"arch": ["resnet20"], "fmt": ["fp32", "mls_e2m1"],
     "backend": ["fake_quant"], "steps": 12}

Every cell carries a ``config_hash`` over exactly the fields that change
the trained math (architecture, proxy shape, numerics, steps, seed -- not
gate tolerances, and not the device), so baseline rows stay keyed to the
cell's semantics.  :func:`chip_grid` is the port's own third grid: the
paper's CIFAR setting at full width, for the card.
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json

from repro_torch.core.formats import EMFormat

__all__ = ["BACKENDS", "CNN_ARCHS", "FORMATS", "GRIDS", "LM_ARCHS", "Cell", "chip_grid",
           "expand_grid", "full_grid", "smoke_grid"]

# The swept <E,M> element formats (paper Table II naming).  ``fp32`` is the
# unquantized reference cell every envelope is measured against.
FORMATS: dict[str, EMFormat | None] = {
    "fp32": None,
    "mls_e2m4": EMFormat(2, 4),   # <2,4>: the paper's ImageNet-scale pick
    "mls_e2m1": EMFormat(2, 1),   # <2,1>: the paper's CIFAR-scale pick
    "fix_e0m4": EMFormat(0, 4),   # fixed point, no element exponent
}

# CNN archs resolve through models/cnn.py; LM families through the smoke
# configs of these architectures (models/lm.py).
LM_ARCHS = {
    "transformer": "qwen2-72b",
    "mamba2": "mamba2-370m",
    "moe": "moonshot-v1-16b-a3b",
}
CNN_ARCHS = ("resnet20", "vgg16", "googlenet")
BACKENDS = ("fake_quant", "pallas")

# Fields that define the trained math -- the config-hash domain.  Gate
# tolerances (envelope_*) deliberately excluded: loosening a tolerance must
# not orphan the baseline row.
_HASH_FIELDS = (
    "arch", "fmt", "backend", "grouping", "steps", "seed",
    "batch", "hw", "width", "seq", "lr",
)


@dataclasses.dataclass(frozen=True)
class Cell:
    """One frontier cell: an (arch, numerics) convergence-proxy run."""

    arch: str            # resnet20 | vgg16 | googlenet | transformer | mamba2 | moe
    fmt: str             # key into FORMATS; "fp32" disables quantization
    backend: str = "fake_quant"   # fake_quant | pallas (the port's "quantized")
    grouping: str = "nc"          # paper Table IV scaling-group layout
    steps: int = 12
    seed: int = 0
    # proxy shape knobs (CNN: batch/hw/width; LM: batch/seq)
    batch: int = 16
    hw: int = 8          # CNN input resolution (vgg16 needs >= 32: 5 pools)
    width: float = 0.25  # CNN width multiplier
    seq: int = 32        # LM sequence length
    lr: float = 0.05     # sgdm lr for CNNs; LM cells use adamw 1e-3
    # Gate envelopes vs the same-arch fp32 fake_quant cell of the same run
    # (paper Table II: <2,1> stays within 1% on CIFAR at full scale; the
    # short proxy needs a looser margin).  None = no envelope.
    envelope_acc: float | None = None   # CNN: acc >= fp32_acc - envelope
    envelope_loss: float | None = None  # LM:  loss <= fp32_loss + envelope

    def __post_init__(self):
        if self.fmt not in FORMATS:
            raise ValueError(f"unknown format {self.fmt!r}; have {sorted(FORMATS)}")
        if self.arch not in CNN_ARCHS and self.arch not in LM_ARCHS:
            raise ValueError(
                f"unknown arch {self.arch!r}; have {sorted(CNN_ARCHS + tuple(LM_ARCHS))}")
        if self.backend not in BACKENDS:
            raise ValueError(f"unknown backend {self.backend!r}")

    @property
    def is_cnn(self) -> bool:
        return self.arch in CNN_ARCHS

    @property
    def emformat(self) -> EMFormat | None:
        return FORMATS[self.fmt]

    def cell_id(self) -> str:
        """Human-readable unique id (the row ``name`` in BENCH_accuracy.json)."""
        parts = [self.arch, self.fmt, self.backend]
        if self.grouping != "nc":
            parts.append(f"g_{self.grouping}")
        return "/".join(parts)

    def config_hash(self) -> str:
        """Stable 12-hex digest of the math-defining fields (baseline key)."""
        payload = {f: getattr(self, f) for f in _HASH_FIELDS}
        blob = json.dumps(payload, sort_keys=True, separators=(",", ":"))
        return hashlib.sha256(blob.encode()).hexdigest()[:12]


def expand_grid(spec_blocks) -> list[Cell]:
    """Expand spec blocks (list-valued axes -> cartesian product) into a
    deduplicated, order-preserving list of cells (dedup by ``config_hash``:
    semantically identical cells run once however the spec is written)."""
    cells: list[Cell] = []
    seen: set[str] = set()
    for block in spec_blocks:
        axes = {k: v if isinstance(v, list) else [v] for k, v in block.items()}
        keys = list(axes)
        for combo in itertools.product(*(axes[k] for k in keys)):
            cell = Cell(**dict(zip(keys, combo)))
            h = cell.config_hash()
            if h not in seen:
                seen.add(h)
                cells.append(cell)
    return cells


# ---------------------------------------------------------------------------
# The JAX package's two committed grids, copied as they are (their cells'
# hashes key both packages' baselines).
# ---------------------------------------------------------------------------
_SMOKE_SPEC = [
    # CIFAR-proxy CNNs across all four formats (paper Table II axis).
    {"arch": "resnet20", "fmt": ["fp32", "mls_e2m4", "mls_e2m1", "fix_e0m4"],
     "backend": "fake_quant", "steps": 12, "batch": 16, "hw": 8,
     "envelope_acc": 0.35},
    {"arch": "vgg16", "fmt": ["fp32", "mls_e2m4", "mls_e2m1"],
     "backend": "fake_quant", "steps": 8, "batch": 8, "hw": 32,
     "width": 0.125, "envelope_acc": 0.45},
    # Beyond-paper LM families (transformer / SSM / MoE low-bit training).
    {"arch": "transformer", "fmt": ["fp32", "mls_e2m4", "mls_e2m1"],
     "backend": "fake_quant", "steps": 8, "batch": 2, "envelope_loss": 0.6},
    {"arch": "mamba2", "fmt": ["mls_e2m4"],
     "backend": "fake_quant", "steps": 8, "batch": 2},
    {"arch": "moe", "fmt": ["mls_e2m4"],
     "backend": "fake_quant", "steps": 8, "batch": 2},
    # Quantized-domain backend on the cheap matmul-path cells.
    {"arch": "mamba2", "fmt": ["mls_e2m4", "mls_e2m1"],
     "backend": "pallas", "steps": 3, "batch": 2},
    {"arch": "transformer", "fmt": ["mls_e2m4"],
     "backend": "pallas", "steps": 3, "batch": 2},
]

_FULL_SPEC = [
    {"arch": "resnet20", "fmt": ["fp32", "mls_e2m4", "mls_e2m1", "fix_e0m4"],
     "backend": "fake_quant", "steps": 40, "batch": 16, "hw": 8,
     "envelope_acc": 0.35},
    # paper Table IV ablation axis: grouping off for the CIFAR pick
    {"arch": "resnet20", "fmt": "mls_e2m1", "grouping": "none",
     "backend": "fake_quant", "steps": 40, "batch": 16, "hw": 8},
    # quantized-domain conv kernels on the CNN path
    {"arch": "resnet20", "fmt": "mls_e2m4", "backend": "pallas",
     "steps": 6, "batch": 8, "hw": 8},
    # lr 0.01: the paper recipe's 0.05 is unstable on the 20-step synthetic
    # vgg proxy (fp32 itself drifts; quantized cells diverge)
    {"arch": "vgg16", "fmt": ["fp32", "mls_e2m4", "mls_e2m1"],
     "backend": "fake_quant", "steps": 20, "batch": 8, "hw": 32,
     "width": 0.125, "lr": 0.01, "envelope_acc": 0.45},
    {"arch": "transformer", "fmt": ["fp32", "mls_e2m4", "mls_e2m1"],
     "backend": "fake_quant", "steps": 20, "batch": 2, "envelope_loss": 0.5},
    {"arch": "transformer", "fmt": "mls_e2m4", "backend": "pallas",
     "steps": 8, "batch": 2},
    {"arch": "mamba2", "fmt": ["fp32", "mls_e2m4", "mls_e2m1"],
     "backend": "fake_quant", "steps": 20, "batch": 2, "envelope_loss": 0.5},
    {"arch": "mamba2", "fmt": ["mls_e2m4", "mls_e2m1"], "backend": "pallas",
     "steps": 8, "batch": 2},
    {"arch": "moe", "fmt": ["fp32", "mls_e2m4", "mls_e2m1"],
     "backend": "fake_quant", "steps": 16, "batch": 2, "envelope_loss": 0.5},
]

# The paper's CIFAR setting at full width, for the card: ResNet-20, 32x32,
# batch 128, 10 classes, lr 0.05, 40 steps.  Quantized cells on "pallas"
# run K1/K3 ("nc") or K2/K3 ("c", "none", paper Table IV); fix_e0m4 stays
# off "pallas" as in the JAX grids (its Pallas quantizer has no E=0 branch).
_CHIP = {"arch": "resnet20", "steps": 40, "batch": 128, "hw": 32, "width": 1.0}
_CHIP_SPEC = [
    {**_CHIP, "fmt": ["fp32", "mls_e2m4", "mls_e2m1", "fix_e0m4"],
     "backend": "fake_quant", "envelope_acc": 0.35},
    {**_CHIP, "fmt": ["mls_e2m4", "mls_e2m1"], "backend": "pallas", "envelope_acc": 0.35},
    {**_CHIP, "fmt": "mls_e2m1", "backend": "pallas", "grouping": ["c", "none"]},
]


def smoke_grid() -> list[Cell]:
    """CI-budget grid (the JAX package's smoke grid)."""
    return expand_grid(_SMOKE_SPEC)


def full_grid() -> list[Cell]:
    """Nightly grid: longer proxies, grouping ablation, pallas conv cell."""
    return expand_grid(_FULL_SPEC)


def chip_grid() -> list[Cell]:
    """The full-width CIFAR frontier for the card (8 cells)."""
    return expand_grid(_CHIP_SPEC)


GRIDS = {"smoke": smoke_grid, "full": full_grid, "chip": chip_grid}
