"""Quantization-coverage audit and kernel verifier of the port.

``--graph train`` runs one ResNet-20 training step at the paper's
``k_block`` 128 (every conv on im2col) and one at 144 (the 3x3 convs'
forward on the implicit-GEMM kernel); ``--graph serve`` one decode step of
the qwen2-72b smoke config on the quantized kernels (batch 4, a filled
cache of 128); ``all`` both.  It classifies every MAC as quantized-domain,
full-precision or data movement, lints each ``QuantConfig`` and the
shipped presets, and writes ``AUDIT_torch_report.json``.  With ``--gate``
the report is checked against ``analysis/baselines/gate.json`` and the
process exits non-zero on any regression.  The serve step's gate (0.61)
is lower than the JAX package's (0.95): the JAX audit counts a Pallas
GEMM's MACs over its zero-padded 128 x 128 tiles (a decode step's 4 rows
as 128), the port counts what each launch computes, and at smoke width
the step's fp32 LM head and attention are large beside its linears.  It runs on the card unless ``--device cpu`` is given (then the
kernels' plain versions run; use a small ``--width/--hw/--batch``).

    PYTHONPATH=src python -m repro_torch.analysis.audit --graph all --kernels --gate

``--kernels`` adds the static kernel verifier
(:mod:`repro_torch.analysis.kernel_verify`): every launch the graphs
recorded, every ``KERNEL_REGISTRY`` entry, the tensor-parallel steps of
``kernel_verify.TP_AUDITS`` and chatglm3-6b's training GEMMs
(``kernel_verify.LM_AUDIT``, K3's wgmma variant) are proven for grid
coverage and ``< 2^24`` integer accumulation, gated against
``analysis/baselines/kernels.json`` (every entry and every device kernel
it names proven); and a ``tune_cache`` section,
``autotune.check_cache`` of the tile cache (the committed seed, or
``--tune-cache PATH``): every registry spec cached and every cached
winner proven.  ``--gate`` fails on a stale cache.

The ``wire_ring`` section (``--no-wire`` skips it) runs the MLS-compressed
cross-pod gradient ring in two gloo processes on the CPU and counts the
bytes each sends (:mod:`repro_torch.analysis.wire`); the gate holds its
compression against fp32 to ``min_wire_compression_ratio``.

``--sabotage MODE`` plants a negative control that must make the gate
fail: ``fp32_gemm`` (an fp32 GEMM on the train hot path), ``overlap_write``
(runs K5, whose output map writes blocks from conflicting programs),
``deep_k`` (K3's launch at a depth whose integer accumulator exceeds 24
bits) or ``drop_halo`` (K4's window proof with the padded input one row
short of its taps).
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

_BASELINE = pathlib.Path(__file__).parent / "baselines" / "gate.json"
_KERNELS_BASELINE = pathlib.Path(__file__).parent / "baselines" / "kernels.json"
TRAIN_K_BLOCKS = (128, 144)  # the paper's im2col path and the implicit path


def build_report(graphs: tuple = ("train",), sabotage: str | None = None,
                 kernels: bool = False, device: str = "cuda", width: float = 1.0,
                 hw: int = 32, batch: int = 128, tune_cache: str | None = None,
                 wire: bool = True) -> dict:
    from repro_torch.analysis.graphs import cifar_train_graph, serve_decode_graph
    from repro_torch.analysis.kernel_verify import SABOTAGE_MODES, run_kernel_audit
    from repro_torch.analysis.lint import lint_quant_config, lint_shipped_presets
    from repro_torch.kernels import recorded_specs
    from repro_torch.runtime import resolve_device

    dev = resolve_device(device)
    report: dict = {"version": 1, "device": str(dev), "graphs": {}}
    recorded = {}
    built = []
    if "train" in graphs:
        built += [cifar_train_graph(k_block, width, hw, batch, dev,
                                    sabotage=sabotage == "fp32_gemm")
                  for k_block in TRAIN_K_BLOCKS]
    if "serve" in graphs:
        built.append(serve_decode_graph(device=dev))
    for g in built:
        cov, records = g.run()
        report["graphs"][g.name] = {**g.meta, "coverage": cov.to_json(),
                                    "launches": sum(records.values()),
                                    "lint": lint_quant_config(g.qcfg).to_json()}
        recorded[g.name] = recorded_specs(records)
    report["presets"] = {name: res.to_json() for name, res in lint_shipped_presets().items()}
    if wire:
        from repro_torch.analysis.wire import audit_wire_ring

        report["wire_ring"] = audit_wire_ring()
    if kernels:
        report["kernels"] = run_kernel_audit(
            sabotage=sabotage if sabotage in SABOTAGE_MODES else None, device=dev.type,
            recorded=recorded)
        from repro_torch.kernels.autotune import SEED_CACHE_PATH, TuneCache, check_cache

        report["tune_cache"] = check_cache(TuneCache.load(tune_cache or SEED_CACHE_PATH),
                                           device=dev.type)
    return report


def apply_gate(report: dict, baseline: dict) -> list[str]:
    """The list of gate failures (empty: pass).  A ``min_quantized_fraction``
    key ``train:resnet20`` holds every graph of that name, whatever its
    ``@kb`` suffix."""
    failures = []
    for key, min_frac in baseline.get("min_quantized_fraction", {}).items():
        for name, entry in report["graphs"].items():
            if name.split("@")[0] != key:
                continue
            frac = entry["coverage"]["quantized_fraction"]
            if frac < min_frac:
                fp_sites = entry["coverage"]["full_precision_sites"]
                failures.append(f"{name}: quantized fraction {frac:.4f} < {min_frac} "
                                f"(largest fp32 site: {fp_sites[0] if fp_sites else None})")
    for name, entry in report["graphs"].items():
        if not entry["lint"]["ok"]:
            failures.append(f"{name}: lint errors {entry['lint']['errors']}")
    for name, res in report.get("presets", {}).items():
        if not res["ok"]:
            failures.append(f"preset {name}: lint errors {res['errors']}")
    wire, min_ratio = report.get("wire_ring"), baseline.get("min_wire_compression_ratio")
    if wire is not None and min_ratio is not None and wire["compression_ratio"] < min_ratio:
        failures.append(f"wire ring: compression ratio {wire['compression_ratio']:.2f} "
                        f"< {min_ratio}")
    failures += apply_kernel_gate(report.get("kernels"), baseline.get("kernels", {}))
    tc = report.get("tune_cache")
    if tc is not None and not tc["ok"]:
        failures += [f"tune cache: {f}" for f in tc["failures"]]
    return failures


def apply_kernel_gate(kernels: dict | None, baseline: dict) -> list[str]:
    """Gate failures from the ``--kernels`` static-verifier section."""
    if kernels is None:
        return []
    failures = []
    reports = kernels.get("kernels", {})
    for name in baseline.get("require_kernels", []):
        if name not in reports:
            failures.append(f"kernel {name}: missing from verifier report")
    proven = {call["kernel"].split(" ")[1].split("[")[0] for rep in reports.values()
              for call in rep.get("calls", []) if " " in call["kernel"]}
    for name in baseline.get("require_device_kernels", []):
        if name not in proven:
            failures.append(f"device kernel {name}: no launch of it proven")
    max_bits = baseline.get("max_integer_accumulation_bits")
    for name, rep in reports.items():
        for call in rep.get("calls", []):
            for v in call.get("violations", []):
                failures.append(f"kernel {name} ({call['kernel']}): {v['kind']} violation "
                                f"at {v['where']}: {v['detail']}")
        bits = rep.get("max_integer_accumulation_bits", 0)
        if max_bits is not None and bits > max_bits:
            failures.append(f"kernel {name}: integer accumulation spans {bits} bits > "
                            f"baseline {max_bits}")
    return failures


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis.audit",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--graph", choices=["train", "serve", "all", "none"], default="train")
    ap.add_argument("--kernels", action="store_true",
                    help="run the static kernel verifier over the recorded launches and "
                         "KERNEL_REGISTRY")
    ap.add_argument("--sabotage", default=None,
                    choices=["fp32_gemm", "overlap_write", "deep_k", "drop_halo"],
                    help="plant a negative control the gate must fail")
    ap.add_argument("--gate", action="store_true",
                    help="check against the baselines; exit 1 on regression")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--width", type=float, default=1.0, help="train graph only")
    ap.add_argument("--hw", type=int, default=32, help="train graph only")
    ap.add_argument("--batch", type=int, default=128, help="train graph only")
    ap.add_argument("--out", default="AUDIT_torch_report.json")
    ap.add_argument("--baseline", default=str(_BASELINE))
    ap.add_argument("--kernels-baseline", default=str(_KERNELS_BASELINE))
    ap.add_argument("--no-wire", action="store_true",
                    help="skip the compressed gradient ring's wire-byte audit")
    ap.add_argument("--tune-cache", default=None, metavar="PATH",
                    help="the tile cache --kernels checks (default: the committed seed)")
    args = ap.parse_args(argv)

    graphs = {"all": ("train", "serve"), "none": ()}.get(args.graph, (args.graph,))
    report = build_report(graphs=graphs,
                          sabotage=args.sabotage, kernels=args.kernels, device=args.device,
                          width=args.width, hw=args.hw, batch=args.batch,
                          tune_cache=args.tune_cache, wire=not args.no_wire)
    baseline = json.loads(pathlib.Path(args.baseline).read_text())
    if args.kernels:
        baseline["kernels"] = json.loads(pathlib.Path(args.kernels_baseline).read_text())
    failures = apply_gate(report, baseline)
    report["gate"] = {"pass": not failures, "failures": failures, "baseline": baseline,
                      "enforced": bool(args.gate)}
    pathlib.Path(args.out).write_text(json.dumps(report, indent=2))

    for name, entry in report["graphs"].items():
        cov = entry["coverage"]
        print(f"{name}: quantized {100 * cov['quantized_fraction']:.2f}% "
              f"({cov['quantized_macs']:,} q / {cov['full_precision_macs']:,} fp / "
              f"{cov['data_movement_macs']:,} dm MACs), "
              f"lint {'OK' if entry['lint']['ok'] else 'FAIL'}")
    if "wire_ring" in report:
        w = report["wire_ring"]
        print(f"wire ring: {w['compression_ratio']:.2f}x vs fp32 "
              f"({w['wire_bytes_per_device']:.0f} B/device)")
    if "kernels" in report:
        ks = report["kernels"]
        for name, rep in ks["kernels"].items():
            print(f"kernel {name}: {'OK' if rep['ok'] else 'FAIL'} "
                  f"({rep['num_launch_specs']} launch spec(s), max int accumulation "
                  f"{rep['max_integer_accumulation_bits']} bits / budget {ks['budget_bits']})")
    if "tune_cache" in report:
        tc = report["tune_cache"]
        print(f"tune cache: {'OK' if tc['ok'] else 'STALE'} ({tc['verified']} winner(s) "
              f"proven, tuned on {tc['device']})")
    if failures:
        print("GATE FAILURES:", file=sys.stderr)
        for msg in failures:
            print(f"  - {msg}", file=sys.stderr)
    else:
        print("gate: PASS")
    print(f"report written to {args.out}")
    return 1 if (failures and args.gate) else 0


if __name__ == "__main__":
    sys.exit(main())
