"""The dry run's sequence-parallel table: every train_4k and prefill_32k cell
of both production meshes under ``SP_RULES`` beside the DEFAULT layout's.

    PYTHONPATH=src python benchmarks/torch_dryrun_sp.py [--jobs 4] [--out DIR]

Runs ``repro_torch.launch.dryrun.run_cell(arch, shape, multi_pod,
seq_shard=True, tag="sp")`` and the same cell without ``seq_shard``, each
in a worker process of its own (a process holds one fake world at a time),
writes the records under ``DIR`` (default ``experiments/torch_dryrun_sp``)
and prints one markdown row an (arch, shape), a cell a mesh: the
microbatch, rank 0's peak and whether it fits the modelled card, wire GB
a step by op (AG all-gather, AR all-reduce, RS reduce-scatter) and by
mesh dim, and the roofline fraction, SP with DEFAULT in parentheses.  No
card: the records are predictions on fake tensors.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SHAPES_RUN = ("train_4k", "prefill_32k")
GIB = 2 ** 30


def _cell(job: tuple) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.launch import dryrun

    arch, shape, multi_pod, sp, out_dir = job
    return dryrun.run_cell(arch, shape, multi_pod, seq_shard=sp, tag="sp" if sp else "",
                           out_dir=out_dir, verbose=False)


def _gb(b: float) -> str:
    return f"{b / 1e9:.1f}"


def _wire(r: dict) -> str:
    """Wire GB a step by op (all-gather, all-reduce, reduce-scatter, ...) and
    by mesh dim."""
    hlo = r["hlo"]
    short = {"all-gather": "AG", "all-reduce": "AR", "reduce-scatter": "RS", "broadcast": "BC",
             "all-to-all": "A2A"}
    ops = " ".join(f"{short.get(op, op)} {_gb(b)}"
                   for op, b in sorted(hlo["coll_breakdown"].items()) if ":" not in op)
    dims = " ".join(f"{d} {_gb(b)}" for d, b in sorted(hlo["coll_by_dim"].items()))
    return f"{ops}; {dims}"


def _describe(sp: dict, dflt: dict) -> str:
    """One cell, SP (DEFAULT): microbatch, rank 0's peak GiB, fits, wire GB
    by op and mesh dim, roofline fraction."""
    mb = f"mb {sp['microbatch']} ({dflt['microbatch']}), " if "microbatch" in sp else ""
    return (f"{mb}{sp['peak_bytes'] / GIB:.2f} ({dflt['peak_bytes'] / GIB:.2f}) GiB, fits "
            f"{sp['fits']} ({dflt['fits']}); {_wire(sp)} ({_wire(dflt)}); roofline "
            f"{sp['roofline']['roofline_fraction']:.3f} "
            f"({dflt['roofline']['roofline_fraction']:.3f})")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(ROOT, "experiments", "torch_dryrun_sp"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ARCHS, runnable_shapes

    cells = [(arch, sh.name) for arch, cfg in ARCHS.items() for sh in runnable_shapes(cfg)
             if sh.name in SHAPES_RUN]
    jobs = [(arch, shape, mp, sp, args.out) for arch, shape in cells for mp in (False, True)
            for sp in (True, False)]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        records = dict(zip(jobs, pool.map(_cell, jobs)))
    print("| arch | shape | 16x16: SP (DEFAULT) | 2x16x16: SP (DEFAULT) |")
    print("|---|---|---|---|")
    failed = []
    for arch, shape in cells:
        row = [records[(arch, shape, mp, sp, args.out)] for mp in (False, True)
               for sp in (True, False)]
        if any(r["status"] != "ran" for r in row):
            failed.append((arch, shape, [r["status"] for r in row]))
            continue
        print(f"| {arch} | {shape} | {_describe(row[0], row[1])} | "
              f"{_describe(row[2], row[3])} |")
    with open(os.path.join(args.out, "table.json"), "w") as f:
        json.dump({f"{k[0]} {k[1]} {'2x16x16' if k[2] else '16x16'} "
                   f"{'sp' if k[3] else 'default'}": {
                       key: v.get(key) for key in ("microbatch", "peak_bytes", "fits", "rules",
                                                    "status", "lint_warnings")}
                   for k, v in records.items()}, f, indent=1)
    print(f"{len(cells) * 2} cells, {len(failed)} not run: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
