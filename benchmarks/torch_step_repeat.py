"""Repeat the full-width ResNet-20 main-path step and name what differs.

    python benchmarks/torch_step_repeat.py [--pairs 40] [--load]
        [--memory-fraction F] [--warn-nondeterministic] [--with-tune-phase]

Each pair runs ``chip_smoke.resnet_step_with`` (ResNet-20 at full width,
batch 128, weights and data from seed 0, K1/K3 at <2,4> "nc", stochastic
rounding) once through the process-wide tile cache and once through an
empty one, as ``chip_smoke.py``'s ``tune`` phase does.  Every step's loss
and gradients are held bit for bit against the first step's; each tensor
that differs is printed with how many elements differ and the largest
difference (``chip_smoke.step_differences``).

``--load`` keeps the card busy from a second process (bf16 GEMMs and a
1 GiB fp32 stream) while the steps run; ``--memory-fraction`` caps this
process's device memory (``torch.cuda.set_per_process_memory_fraction``);
``--warn-nondeterministic`` turns on
``torch.use_deterministic_algorithms(True, warn_only=True)``, which names
every op without a deterministic implementation and fills each
``torch.empty`` (NaN for floats), so a read of unwritten memory shows;
``--with-tune-phase`` first runs ``chip_smoke.py``'s ``kernels`` and
``tune`` phases in this process.  The last line is one JSON object.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_LOAD = """
import time, torch
a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
b = torch.randn(1 << 28, device="cuda")
t = time.time()
while time.time() - t < {seconds}:
    for _ in range(4):
        a @ a
    b.mul_(1.0000001)
    torch.cuda.synchronize()
"""


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=40)
    ap.add_argument("--load", action="store_true")
    ap.add_argument("--memory-fraction", type=float, default=None)
    ap.add_argument("--warn-nondeterministic", action="store_true")
    ap.add_argument("--with-tune-phase", action="store_true")
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    from repro_torch.runtime import resolve_device

    resolve_device("cuda")  # raises without a card; TF32 off, as chip_smoke.py runs
    import chip_smoke as cs
    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.kernels import autotune as at
    from repro_torch.kernels import build
    from repro_torch.sweep.record import nvidia_smi

    build.library()
    smi = nvidia_smi()
    load = None
    if args.load:
        load = subprocess.Popen([sys.executable, "-c", _LOAD.format(seconds=30 * args.pairs)])
        time.sleep(8)  # the load process reaches the card
    if args.memory_fraction is not None:
        torch.cuda.set_per_process_memory_fraction(args.memory_fraction)
    if args.warn_nondeterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    t0 = time.perf_counter()
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if args.with_tune_phase:
                results = {"nvidia_smi": smi}
                cs.phase_kernels(results)
                cs.phase_tune(results)
            qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=cs.K_BLOCK, grouping="nc",
                               stochastic=True)
            empty = at.TuneCache(device=at.device_name("cuda"))
            first, differing, steps = None, {}, 0
            for i in range(args.pairs):
                for tag, cache in (("seed", at.get_cache()), ("empty", empty)):
                    u = cs.resnet_step_with(cache, qcfg)
                    steps += 1
                    if first is None:
                        first = u
                    elif d := cs.step_differences(first, u):
                        differing[f"pair {i} {tag} cache"] = d
                        print(json.dumps({"differs": f"pair {i} {tag} cache", "tensors": d}),
                              flush=True)
    finally:
        if load is not None:
            load.kill()
            load.wait()
    flagged = sorted({str(w.message).splitlines()[0] for w in caught
                      if "deterministic" in str(w.message)})
    print(json.dumps({"steps": steps, "differing_steps": len(differing),
                      "loss": float(first["loss"]),
                      "load": args.load, "memory_fraction": args.memory_fraction,
                      "warn_nondeterministic": args.warn_nondeterministic,
                      "flagged_ops": flagged, "with_tune_phase": args.with_tune_phase,
                      "s": time.perf_counter() - t0, "nvidia_smi": smi}))
    return 1 if differing else 0


if __name__ == "__main__":
    sys.exit(main())
