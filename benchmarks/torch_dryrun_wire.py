"""The dry run's FSDP wire-format table: every train_4k cell of both
production meshes under DEFAULT, the 2-byte gather
(``param_gather_dtype="bfloat16"``), the 1-byte gather (``packed_wire``)
and both.

    PYTHONPATH=src python benchmarks/torch_dryrun_wire.py [--jobs 3] [--out DIR]

Runs ``repro_torch.launch.dryrun.run_cell(arch, "train_4k", multi_pod,
cfg_updates=LEVERS[lever], tag=lever)``, each cell in a worker process of
its own (a process holds one fake world at a time), writes the records
under ``DIR`` (default ``experiments/torch_dryrun_wire``) and prints one
markdown row an (arch, mesh), each cell DEFAULT / bf16 / packed / both:
rank 0's all-gather and reduce-scatter GB a step, its data-axis GB, its
peak GiB and the roofline fraction (the bound named where it is not the
collectives).  No card: the records are predictions on fake tensors.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LEVERS = {"default": {}, "bf16": {"param_gather_dtype": "bfloat16"},
          "packed": {"packed_wire": True},
          "both": {"param_gather_dtype": "bfloat16", "packed_wire": True}}
GIB = 2 ** 30


def _cell(job: tuple) -> dict:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch

    from repro_torch.launch import dryrun

    torch.set_num_threads(1)
    arch, multi_pod, lever, out_dir = job
    return dryrun.run_cell(arch, "train_4k", multi_pod, cfg_updates=LEVERS[lever],
                           tag="" if lever == "default" else lever, out_dir=out_dir,
                           verbose=False)


def _values(r: dict) -> list[str]:
    """One record's columns."""
    ops, rf = r["hlo"]["coll_breakdown"], r["roofline"]
    bound = "" if rf["bottleneck"] == "collective" else f" {rf['bottleneck']}"
    return [f"{ops.get('all-gather', 0) / 1e9:.1f}", f"{ops.get('reduce-scatter', 0) / 1e9:.1f}",
            f"{r['hlo']['coll_by_dim'].get('data', 0) / 1e9:.1f}", f"{r['peak_bytes'] / GIB:.2f}",
            f"{rf['roofline_fraction']:.3f}{bound}"]


def _row(arch: str, mesh: str, rs: list[dict]) -> str:
    """One (arch, mesh): each column the levers' values, DEFAULT first."""
    if any(r["status"] != "ran" for r in rs):
        return f"| {arch} | {mesh} | {[r['status'] for r in rs]} | | | | |"
    cols = zip(*(_values(r) for r in rs))
    return f"| {arch} | {mesh} | " + " | ".join(" / ".join(c) for c in cols) + " |"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "experiments", "torch_dryrun_wire"))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.configs import ARCHS, runnable_shapes

    archs = [a for a, cfg in ARCHS.items() if "train_4k" in {s.name for s in runnable_shapes(cfg)}]
    jobs = [(arch, mp, lever, args.out) for arch in archs for mp in (False, True)
            for lever in LEVERS]
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(args.jobs, mp_context=ctx) as pool:
        records = dict(zip(jobs, pool.map(_cell, jobs)))
    print("| arch | mesh | all-gather GB | reduce-scatter GB | data axis GB | peak GiB | "
          "roofline |")
    print("|---|---|---|---|---|---|---|")
    for arch in archs:
        for mp in (False, True):
            print(_row(arch, "2x16x16" if mp else "16x16",
                       [records[(arch, mp, lever, args.out)] for lever in LEVERS]))
    with open(os.path.join(args.out, "table.json"), "w") as f:
        json.dump({f"{k[0]} {'2x16x16' if k[1] else '16x16'} {k[2]}": {
            "status": v["status"], "all_gather": v.get("hlo", {}).get("coll_breakdown", {}),
            "coll_by_dim": v.get("hlo", {}).get("coll_by_dim"), "peak_bytes": v.get("peak_bytes"),
            "roofline": v.get("roofline"), "lint_warnings": v.get("lint_warnings")}
            for k, v in records.items()}, f, indent=1)
    failed = [k[:3] for k, v in records.items() if v["status"] != "ran"]
    print(f"{len(records)} cells, {len(failed)} not run: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
