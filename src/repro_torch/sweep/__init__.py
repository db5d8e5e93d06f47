"""Bit-width x architecture frontier sweep, on the port.

The port of the JAX package's ``repro.sweep``: short convergence-proxy
training runs over a declarative grid of ``(<E,M> format x grouping x
backend) x architecture`` cells -- the paper's Tables II-IV accuracy /
bit-width surface, extended to the transformer / Mamba2 / MoE low-bit
paths -- one ``BENCH_accuracy.json`` row per cell, and a trend gate against
the port's committed baseline (``sweep/baselines/accuracy.json``) with
per-cell tolerances::

    PYTHONPATH=src python -m repro_torch.sweep --smoke --device cpu --gate
    PYTHONPATH=src python -m repro_torch.sweep --chip --gate   # on the card

The smoke and full grids are the JAX package's (same cells, same config
hashes); the chip grid is the paper's CIFAR setting at full width.
"""
from .gate import apply_gate, build_baseline, load_baseline, sabotage_baseline
from .grid import FORMATS, Cell, chip_grid, expand_grid, full_grid, smoke_grid
from .report import frontier_table
from .runner import run_cell, run_cells, train_cell

__all__ = [
    "FORMATS",
    "Cell",
    "apply_gate",
    "build_baseline",
    "chip_grid",
    "expand_grid",
    "frontier_table",
    "full_grid",
    "load_baseline",
    "run_cell",
    "run_cells",
    "sabotage_baseline",
    "smoke_grid",
    "train_cell",
]
