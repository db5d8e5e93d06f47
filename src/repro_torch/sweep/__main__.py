"""Frontier sweep CLI (the port of ``python -m repro.sweep``, with the same
flags and exit codes, plus ``--chip`` and ``--device``).

Run the smoke grid on the CPU and gate it against the committed baseline::

    PYTHONPATH=src python -m repro_torch.sweep --smoke --device cpu --gate

The full-width CIFAR frontier on the card (CUDA is the default device)::

    PYTHONPATH=src python -m repro_torch.sweep --chip --gate \\
        --out BENCH_accuracy.json --markdown frontier.md

Re-gate a saved artifact without re-training (a sabotaged baseline must
make this exit non-zero)::

    PYTHONPATH=src python -m repro_torch.sweep --gate --from BENCH_accuracy.json
    PYTHONPATH=src python -m repro_torch.sweep --gate --sabotage --from BENCH_accuracy.json

Bless a new or changed grid (the smoke and full grids on the CPU, the chip
grid on the card)::

    PYTHONPATH=src python -m repro_torch.sweep --smoke --device cpu --update-baseline

Exit codes: 0 pass (or report only, without ``--gate``), 1 gate failures
under ``--gate``, 2 a usage refusal (``--only`` matching nothing,
``--update-baseline`` of a partial or sabotaged run).
"""
from __future__ import annotations

import argparse
import json
import sys

from .gate import (
    BASELINE_PATH,
    SABOTAGE_MODES,
    apply_gate,
    build_baseline,
    load_baseline,
    sabotage_baseline,
)
from .grid import GRIDS
from .record import make_payload, write_json
from .report import frontier_table
from .runner import run_cells


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sweep", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--smoke", action="store_true", help="CI-budget grid (default)")
    mode.add_argument("--full", action="store_true", help="nightly grid")
    mode.add_argument("--chip", action="store_true",
                      help="the full-width CIFAR frontier (for the card)")
    ap.add_argument("--only", default=None, metavar="SUBSTR",
                    help="run only cells whose id contains SUBSTR "
                         "(error if nothing matches)")
    ap.add_argument("--list", action="store_true",
                    help="print the grid cells and exit")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write rows as a BENCH_accuracy.json artifact")
    ap.add_argument("--from", dest="from_path", default=None, metavar="PATH",
                    help="gate/report a saved artifact instead of training")
    ap.add_argument("--markdown", default=None, metavar="PATH",
                    help="write the frontier markdown table here")
    ap.add_argument("--baseline", default=str(BASELINE_PATH))
    ap.add_argument("--gate", action="store_true",
                    help="check against the baseline; exit 1 on regression")
    ap.add_argument("--sabotage", nargs="?", const="regress", default=None,
                    choices=list(SABOTAGE_MODES),
                    help="corrupt the baseline in-memory: the gate MUST "
                         "fail on a healthy run (negative control)")
    ap.add_argument("--update-baseline", action="store_true",
                    help=f"bless this run into {BASELINE_PATH}")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda; cpu runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    grid_name = "full" if args.full else "chip" if args.chip else "smoke"
    if args.update_baseline and args.sabotage:
        print("refusing to --update-baseline under --sabotage", file=sys.stderr)
        return 2

    if args.from_path:
        with open(args.from_path) as f:
            payload = json.load(f)
        rows = payload["rows"]
        grid_name = payload.get("grid", grid_name)
        if grid_name == "partial":
            grid_name = None
    else:
        grid = GRIDS[grid_name]()
        cells = grid
        if args.only:
            cells = [c for c in grid if args.only in c.cell_id()]
            if not cells:
                print(f"--only {args.only!r} matches no cell; have:\n  "
                      + "\n  ".join(c.cell_id() for c in grid),
                      file=sys.stderr)
                return 2
            grid_name = None  # partial run: skip reverse-coverage gating
        if args.list:
            for c in cells:
                print(f"{c.cell_id()}  hash={c.config_hash()}  steps={c.steps}")
            return 0
    if args.update_baseline and grid_name is None:
        print("refusing to --update-baseline from a partial (--only) run", file=sys.stderr)
        return 2
    if not args.from_path:
        rows = run_cells(cells, args.device)
        payload = make_payload("frontier_sweep", rows, quick=not (args.full or args.chip),
                               extra={"grid": grid_name or "partial"}, device=args.device)

    if args.out:
        write_json(args.out, payload)

    md = frontier_table(
        rows, title=f"Bit-width × architecture frontier ({grid_name or 'partial'} grid)")
    if args.markdown:
        with open(args.markdown, "w") as f:
            f.write(md)
        print(f"wrote {args.markdown}")
    else:
        print(md)

    if args.update_baseline:
        try:
            existing = load_baseline(args.baseline)
        except FileNotFoundError:
            existing = None
        with open(args.baseline, "w") as f:
            json.dump(build_baseline(rows, grid_name, existing), f, indent=2)
            f.write("\n")
        print(f"baseline updated: {args.baseline}")
        return 0

    baseline = load_baseline(args.baseline)
    if args.sabotage:
        baseline = sabotage_baseline(baseline, args.sabotage, grid_name)
    failures = apply_gate(rows, baseline, grid_name=grid_name)
    if failures:
        print("GATE FAILURES:", file=sys.stderr)
        for fmsg in failures:
            print(f"  - {fmsg}", file=sys.stderr)
    else:
        print("gate: PASS")
    return 1 if (failures and args.gate) else 0


if __name__ == "__main__":
    sys.exit(main())
