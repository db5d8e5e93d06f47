"""Paper Table II (convergence proxy) on the PyTorch port: train the same
reduced ResNet-20 on synthetic CIFAR under fp32 / MLS<2,4> / MLS<2,1> /
fixed-point (Ex=0) / <2,1> without grouping and compare loss and
accuracy.  The counterpart of ``table2_accuracy.py``, with the same
variants and proxy shape (ResNet-20, hw 16, batch 32, width 0.25; 40
steps, 300 with ``--full``), riding on the port's frontier-sweep runner
(``repro_torch.sweep``); the port's weights, batches and rounding streams
are its own, so its numbers are close to, not equal to, the JAX file's.
It writes a stamped JSON artifact through ``repro_torch.sweep.record``::

    PYTHONPATH=src python benchmarks/torch_table2_accuracy.py --device cpu \\
        --json BENCH_torch_table2.json
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.sweep.grid import Cell  # noqa: E402
from repro_torch.sweep.record import make_payload, write_json  # noqa: E402
from repro_torch.sweep.runner import run_cell  # noqa: E402

# name -> Cell kwargs on top of the Table II proxy shape
VARIANTS = {
    "fp32": {"fmt": "fp32"},
    "mls_e2m4": {"fmt": "mls_e2m4"},
    "mls_e2m1": {"fmt": "mls_e2m1"},
    "fix_e0m4": {"fmt": "fix_e0m4"},
    "nogroup_e2m1": {"fmt": "mls_e2m1", "grouping": "none"},
}


def run(quick: bool = True, device: str = "cuda"):
    steps = 40 if quick else 300
    rows = []
    base_acc = None
    for name, kw in VARIANTS.items():
        cell = Cell(arch="resnet20", batch=32, hw=16, width=0.25,
                    steps=steps, **kw)
        r = run_cell(cell, device)
        acc, loss = r["final_acc"], r["final_loss"]
        if name == "fp32":
            base_acc = acc
        drop = (base_acc - acc) if base_acc is not None else 0.0
        loss_s = "nan" if loss is None else f"{loss:.3f}"
        rows.append({
            "name": f"table2/{name}",
            "us_per_call": round(r["wall_time_s"] * 1e6 / steps, 1),
            "derived": f"loss={loss_s} acc={acc:.3f} drop={drop:+.3f}",
            "config_hash": r["config_hash"],
            "final_loss": loss,
            "final_acc": acc,
            "diverged": r["diverged"],
            "steps": steps,
        })
    return rows


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--full", action="store_true",
                    help="300-step proxy (the nightly setting)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write rows as a BENCH_*.json artifact")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rows = run(quick=not args.full, device=args.device)
    for r in rows:
        print(f'{r["name"]},{r["us_per_call"]:.1f},"{r["derived"]}"', flush=True)
    if args.json:
        write_json(args.json, make_payload("table2_accuracy", rows,
                                           quick=not args.full, device=args.device))
    return rows


if __name__ == "__main__":
    main()
