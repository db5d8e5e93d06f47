"""K3's wgmma variant against the walk or ordered split on the card: the
measurement behind ``mls_matmul.matmul_plan``'s wgmma threshold.

    python benchmarks/torch_k3_wgmma_sweep.py [--json chiprun_out/k3_wgmma_sweep.json]

For every GEMM of ``chip_smoke.py``'s LM paths (``lm_train_gemms``,
``serve_gemms``, ``TP_K3_SHAPES``) and a grid of M in 128..8192, N in
128..4096 and 1..32 groups of 128, where the wgmma variant is legal and M,
N >= 128: K1's codes of random operands (<2,4>, "nc", stochastic), the
wgmma variant's output against the plan ``matmul_plan`` makes without it
(bit for bit), and both timed by ``autotune.device_ms`` (the tuner's
timer: events around each call with the host run ahead), twice in turns
(legacy, wgmma, legacy, wgmma; the faster of each pair kept).  The large
shapes also get the wgmma variant's kernels alone (``torch.profiler``) and
the card's clock and power beside them.  Needs a card; exits 1 on a
mismatch.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

GRID_M = (128, 256, 512, 1024, 2048, 4096, 8192)
GRID_N = (128, 256, 1024, 4096)
GRID_GROUPS = (1, 2, 4, 8, 16, 32)


def legacy_plan(M: int, N: int, K: int, kb: int, fmt):
    """matmul_plan's choice with the wgmma variant taken out of its rule."""
    from repro_torch.kernels import mls_matmul as _  # noqa: F401

    mod = sys.modules["repro_torch.kernels.mls_matmul"]
    saved = mod.WGMMA_MIN_TILES
    mod.WGMMA_MIN_TILES = 1 << 62
    try:
        return mod.matmul_plan(M, N, K, kb, fmt)
    finally:
        mod.WGMMA_MIN_TILES = saved


def shapes() -> dict[str, tuple[int, int, int]]:
    import chip_smoke as cs

    kb = cs.K_BLOCK
    out = {}
    for name, (M, K, N, _) in cs.lm_train_gemms().items():
        out[f"train {name}"] = (M, -(-K // kb) * kb, N)
    for name, (M, K, N, _) in cs.serve_gemms().items():
        out[f"serve {name}"] = (M, -(-K // kb) * kb, N)
    for name, (M, K, N) in cs.TP_K3_SHAPES.items():
        out[f"tp {name}"] = (M, K, N)
    for M in GRID_M:
        for N in GRID_N:
            for g in GRID_GROUPS:
                out[f"grid {M}x{g * kb}x{N}"] = (M, g * kb, N)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", default=str(ROOT / "chiprun_out" / "k3_wgmma_sweep.json"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the sweep times kernels on the card: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import build, mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.autotune import device_ms
    from repro_torch.kernels.mls_matmul import WGMMA_BN, MatmulPlan, wgmma_refusal

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    build.library()
    wg = MatmulPlan("wgmma", "int8", WGMMA_BN, 0)
    fmt, kb = FMT_IMAGENET, cs.K_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(0)
    seen, rows = set(), []
    for name, (M, K, N) in shapes().items():
        if (M, K, N) in seen or M < WGMMA_BN or N < WGMMA_BN or wgmma_refusal(M, N, K, kb, fmt):
            continue
        seen.add((M, K, N))
        x = torch.randn((M, K), generator=gen, device="cuda")
        wt = torch.randn((N, K), generator=gen, device="cuda")
        xc, xsg, xst = mls_quantize(x, fmt, kb, GS_FMT_DEFAULT,
                                    rounding_bytes(x.shape, gen, x.device))
        wc, wsg, wst = mls_quantize(wt, fmt, kb, GS_FMT_DEFAULT,
                                    rounding_bytes(wt.shape, gen, wt.device))
        del x, wt
        call = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        old = legacy_plan(M, N, K, kb, fmt)
        same = torch.equal(mls_matmul(*call, "nc", plan=wg), mls_matmul(*call, "nc", plan=old))
        n = 10 if M * N * K > 1e11 else 30
        run_old = lambda: mls_matmul(*call, "nc", plan=old)  # noqa: E731
        run_wg = lambda: mls_matmul(*call, "nc", plan=wg)  # noqa: E731
        t_old, t_wg = device_ms(run_old, n), device_ms(run_wg, n)
        t_old, t_wg = min(t_old, device_ms(run_old, n)), min(t_wg, device_ms(run_wg, n))
        row = dict(name=name, mkn=(M, K, N), groups=K // kb, tiles=-(-M // 128) * -(-N // 128),
                   old=old.variant, old_bn=old.bn, old_ms=t_old, wgmma_ms=t_wg,
                   speedup=t_old / t_wg, same=same)
        if M * N * K > 4e11:
            row["wgmma_kernel_ms"] = cs.kernel_ms(run_wg, ("mls_matmul_wgmma",
                                                           "mls_matmul_decode"))
            row["smi"] = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                                         "--format=csv,noheader"], capture_output=True,
                                        text=True).stdout.strip()
        rows.append(row)
        print(json.dumps(row), flush=True)
        del call, xc, wc
        torch.cuda.empty_cache()
    out = Path(args.json)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"nvidia_smi": smi, "rows": rows}, indent=1))
    bad = [r["name"] for r in rows if not r["same"]]
    print(f"{len(rows)} shapes, {len(bad)} mismatches {bad[:5]}; written to {out}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
