"""Trend gate: compare a sweep run against the committed accuracy baseline.

The port of the JAX package's ``sweep/gate.py``, with the same defaults and
failure messages (which name the port's CLI).  The port's baseline is its
own file (``repro_torch/sweep/baselines/accuracy.json``, the JAX schema):
its weights, data and rounding streams are its own, so the JAX baseline's
numbers are not its numbers.

The baseline holds one entry per cell
``config_hash`` with the blessed convergence metrics and which grid(s) the
cell belongs to.  Gating is per-cell with explicit tolerances:

* a cell missing from the baseline fails (refresh with
  ``--update-baseline`` — new frontier cells must be blessed on purpose);
* a baseline cell of the current grid missing from the run fails (the grid
  silently shrank);
* a cell that *newly* diverges fails; a baseline-diverged cell may stay
  diverged (the paper expects pure fixed point to degrade or diverge);
* ``final_loss`` may not regress more than ``loss_tol`` and ``final_acc``
  may not drop more than ``acc_tol`` (per-cell overrides in the baseline
  entry, else the defaults below);
* envelope cells additionally compare against the same-arch fp32 cell of
  the *same run* — the paper's "<2,1> stays within 1% of fp32 on CIFAR"
  claim scaled to the short proxy's noise floor.

``sabotage_baseline`` plants a negative control (CI runs it to prove the
gate can fail): it rewrites the blessed metrics so a healthy run looks
like a regression, or drops a cell so the run looks unblessed.
"""
from __future__ import annotations

import copy
import json
import pathlib

__all__ = [
    "DEFAULT_ACC_TOL",
    "DEFAULT_LOSS_TOL",
    "SABOTAGE_MODES",
    "apply_gate",
    "build_baseline",
    "load_baseline",
    "sabotage_baseline",
]

BASELINE_PATH = pathlib.Path(__file__).parent / "baselines" / "accuracy.json"

# Metrics are deterministic on one software stack (seeded cells); the
# tolerances absorb cross-machine float reduction differences only.
DEFAULT_LOSS_TOL = 0.25
DEFAULT_ACC_TOL = 0.20

SABOTAGE_MODES = ("regress", "missing_cell")


def load_baseline(path: str | pathlib.Path | None = None) -> dict:
    with open(path or BASELINE_PATH) as f:
        return json.load(f)


def _fp32_reference(rows: list[dict], arch: str) -> dict | None:
    """The same-run fp32 fake-quant cell every envelope is measured against."""
    for r in rows:
        if (r["arch"] == arch and r["fmt"] == "fp32"
                and r["backend"] == "fake_quant" and r["grouping"] == "nc"):
            return r
    return None


def apply_gate(rows: list[dict], baseline: dict,
               grid_name: str | None = None) -> list[str]:
    """Return the list of human-readable gate failures (empty = pass)."""
    failures: list[str] = []
    cells = baseline.get("cells", {})
    by_hash = {r["config_hash"]: r for r in rows}

    for r in rows:
        cid, h = r["cell_id"], r["config_hash"]
        base = cells.get(h)
        if base is None:
            failures.append(
                f"{cid}: cell {h} not in baseline — bless new/changed cells "
                f"with `python -m repro_torch.sweep --update-baseline`")
            continue
        loss_tol = base.get("loss_tol", DEFAULT_LOSS_TOL)
        acc_tol = base.get("acc_tol", DEFAULT_ACC_TOL)
        if r["diverged"] and not base.get("diverged", False):
            failures.append(
                f"{cid}: newly diverged (loss={r['final_loss']}, "
                f"baseline loss={base.get('final_loss')})")
            continue
        if (r["final_loss"] is not None and base.get("final_loss") is not None
                and r["final_loss"] > base["final_loss"] + loss_tol):
            failures.append(
                f"{cid}: final_loss {r['final_loss']:.4f} regressed past "
                f"baseline {base['final_loss']:.4f} + tol {loss_tol}")
        if (r["final_acc"] is not None and base.get("final_acc") is not None
                and r["final_acc"] < base["final_acc"] - acc_tol):
            failures.append(
                f"{cid}: final_acc {r['final_acc']:.4f} regressed past "
                f"baseline {base['final_acc']:.4f} - tol {acc_tol}")

    # reverse coverage: the current grid may not silently lose blessed cells
    if grid_name is not None:
        for h, base in cells.items():
            if grid_name in base.get("grids", ()) and h not in by_hash:
                failures.append(
                    f"{base.get('cell_id', h)}: baseline cell {h} of grid "
                    f"'{grid_name}' missing from the run (grid shrank — "
                    f"refresh the baseline if intentional)")

    # paper-envelope checks against the same run's fp32 reference cells
    for r in rows:
        env_acc, env_loss = r.get("envelope_acc"), r.get("envelope_loss")
        if env_acc is None and env_loss is None:
            continue
        if r["fmt"] == "fp32":
            continue  # the reference itself
        ref = _fp32_reference(rows, r["arch"])
        if ref is None:
            failures.append(
                f"{r['cell_id']}: envelope requested but no fp32 reference "
                f"cell for arch {r['arch']} in this run")
            continue
        if (env_acc is not None and r["final_acc"] is not None
                and ref["final_acc"] is not None
                and r["final_acc"] < ref["final_acc"] - env_acc):
            failures.append(
                f"{r['cell_id']}: final_acc {r['final_acc']:.4f} fell out of "
                f"the fp32 envelope ({ref['final_acc']:.4f} - {env_acc})")
        if (env_loss is not None and r["final_loss"] is not None
                and ref["final_loss"] is not None
                and r["final_loss"] > ref["final_loss"] + env_loss):
            failures.append(
                f"{r['cell_id']}: final_loss {r['final_loss']:.4f} fell out "
                f"of the fp32 envelope ({ref['final_loss']:.4f} + {env_loss})")
    return failures


def build_baseline(rows: list[dict], grid_name: str,
                   existing: dict | None = None) -> dict:
    """Merge a run into the baseline: bless this grid's cells, keep the
    other grid's entries and any per-cell tolerance overrides untouched."""
    out = copy.deepcopy(existing) if existing else {"schema_version": 1, "cells": {}}
    cells = out.setdefault("cells", {})
    # drop stale entries of this grid that the current grid no longer has
    current = {r["config_hash"] for r in rows}
    for h in list(cells):
        grids = set(cells[h].get("grids", ()))
        if grid_name in grids and h not in current:
            grids.discard(grid_name)
            if not grids:
                del cells[h]
            else:
                cells[h]["grids"] = sorted(grids)
    for r in rows:
        prev = cells.get(r["config_hash"], {})
        entry = {
            "cell_id": r["cell_id"],
            "grids": sorted(set(prev.get("grids", ())) | {grid_name}),
            "final_loss": r["final_loss"],
            "final_acc": r["final_acc"],
            "diverged": r["diverged"],
        }
        for tol in ("loss_tol", "acc_tol"):  # preserve manual overrides
            if tol in prev:
                entry[tol] = prev[tol]
        cells[r["config_hash"]] = entry
    return out


def sabotage_baseline(baseline: dict, mode: str = "regress",
                      grid_name: str | None = None) -> dict:
    """Negative control: corrupt the baseline so a healthy run MUST fail.
    ``"missing_cell"`` drops the first cell blessed for ``grid_name`` (the
    baseline's first cell when None, as the JAX package does whatever the
    grid: a run of a grid that lacks that cell would still pass)."""
    if mode not in SABOTAGE_MODES:
        raise ValueError(f"unknown sabotage mode {mode!r}; have {SABOTAGE_MODES}")
    out = copy.deepcopy(baseline)
    cells = out.get("cells", {})
    if not cells:
        raise ValueError("cannot sabotage an empty baseline")
    if mode == "missing_cell":
        of_grid = [h for h, e in cells.items()
                   if grid_name is None or grid_name in e.get("grids", ())]
        if not of_grid:
            raise ValueError(f"no baseline cell of grid {grid_name!r} to drop")
        del cells[of_grid[0]]
        return out
    for entry in cells.values():  # "regress"
        if entry.get("final_loss") is not None:
            entry["final_loss"] -= 1.0
        if entry.get("final_acc") is not None:
            entry["final_acc"] = min(1.0, entry["final_acc"] + 0.5)
        entry["diverged"] = False
    return out
