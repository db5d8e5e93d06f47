"""The port's kernel bench: K1-K5 at the shapes of PERF.md's kernel table
(the ResNet-20 main path, LM serving and LM training), on the card.

For each row it times the call the tile cache steers (``autotune.config_call``:
K1/K2 ``mls_quantize``, K3 ``mls_matmul`` on pre-made codes, K4 the conv's
forward, K5 ``sabotage_overlap_matmul``) at the default choice
(``autotune.default_block_config``) and at the resolved one (the seed
cache's for this card, ``autotune.resolve_block_config``): CUDA events,
median of 20 calls after 3 warm-ups (one timing where both are the same
choice), each call synchronised (``ms``: the wrapper's host time
included) and with the host run ahead (``device_ms``, the tuner's timer,
``autotune.device_ms``); the tuned choice's kernels alone by
``torch.profiler`` (mean of 10 calls, None
unless every call's kernels were recorded); the bound, the larger of the
bytes the function must move (inputs read and outputs written once) at
3.35 TB/s and its int8 operations at 1,979 TOP/s (an H100 SXM's data
sheet); launches per training step where the main path has the shape;
the bytes models of the conv's two lowerings on K4's rows.  It writes
``BENCH_torch_kernels.json`` through ``repro_torch.sweep.record``, with
the card's nvidia-smi name and power limit.

    python benchmarks/torch_kernel_bench.py [--json PATH] [--rows SUBSTRING]
    PYTHONPATH=src python benchmarks/torch_kernel_bench.py --device cpu --small

It runs on the card (``cuda``) unless asked for the CPU; there
(``--small``: tiny shapes) it runs the kernels' plain versions and
reports no time.
"""
import argparse
import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core.formats import FMT_IMAGENET  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import implicit_conv as ic  # noqa: E402
from repro_torch.runtime import resolve_device  # noqa: E402
from repro_torch.sweep.record import make_payload, nvidia_smi, write_json  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
PROFILER_PAD = 256  # small kernels that open each profiler session
# the device kernels (profiler names) of each C entry point
DEVICE_KERNELS = {
    "mls_quantize_rows": ("quantize_amax", "quantize_groups_warp", "quantize_groups_block"),
    "mls_quantize_given_sg": ("quantize_cols_amax", "quantize_cols_reduce", "quantize_scales",
                              "quantize_codes", "quantize_amax"),
    "mls_matmul": ("mls_matmul_walk", "mls_matmul_terms", "mls_matmul_sum", "mls_matmul_decode",
                   "mls_matmul_wgmma"),
    "implicit_conv": ("conv_amax", "implicit_conv_kernel", "conv_win_amax", "conv_chan_amax",
                      "conv_group_reduce", "conv_chan_scales", "quantize_amax",
                      "quantize_groups_warp", "quantize_groups_block", "quantize_cols",
                      "quantize_scales", "quantize_codes", "mls_matmul"),
    "sabotage_overlap": ("sabotage_overlap",),
}
STAGE = {1: ((128, 16, 32, 32), (16, 16, 3, 3), 1), 2: ((128, 16, 32, 32), (32, 16, 3, 3), 2),
         3: ((128, 64, 8, 8), (64, 64, 3, 3), 1)}
# PERF.md's launches per ResNet-20 training step (k_block 128 main path;
# "c" for K2; k_block 144 implicit path for K4)
MAIN_LAUNCHES = {"mls_quantize_rows": 120, "mls_quantize_given_sg": 120, "mls_matmul": 60,
                 "implicit_conv": 18, "sabotage_overlap": 0}


def _rows(small: bool) -> list[tuple]:
    """(kernel, label, TuneSpec or None, main-path row) per row."""
    F = FMT_IMAGENET
    if small:
        g = ic.conv_geometry((2, 16, 8, 8), (16, 16, 3, 3), (1, 1), "SAME")
        return [("mls_quantize_rows", "small (64, 256)", at.TuneSpec("quantize", (64, 256), F), 1),
                ("mls_quantize_given_sg", "small (64, 256) c",
                 at.TuneSpec("quantize", (64, 256), F, 128, "c"), 1),
                ("mls_matmul", "small 64 x 256 x 16", at.TuneSpec("gemm", (64, 256, 16), F), 1),
                ("implicit_conv", "small x (2,16,8,8) w (16,16,3,3) nc",
                 at.TuneSpec("conv", ic.conv_tune_dims(g, 144), F, 144), 1),
                ("sabotage_overlap", "x (8, 16) @ w (16, 32)", None, 1)]
    q = lambda m, k, g="nc": at.TuneSpec("quantize", (m, k), F, 128, g)  # noqa: E731
    gm = lambda m, k, n: at.TuneSpec("gemm", (m, k, n), F)  # noqa: E731
    rows = [
        ("mls_quantize_rows", "stage1_fwd_cols (131072, 256)", q(131072, 256), 1),
        ("mls_quantize_rows", "stage1_wgrad_colsT (144, 131072)", q(144, 131072), 1),
        ("mls_quantize_rows", "serve chatglm3 w_up^T (13696, 4096)", q(13696, 4096), 0),
        ("mls_quantize_rows", "serve chatglm3 x (4, 4096)", q(4, 4096), 0),
        ("mls_quantize_rows", "lm_train chatglm3 x (8192, 4096)", q(8192, 4096), 0),
        ("mls_quantize_rows", "lm_train chatglm3 (8192, 13696)", q(8192, 13696), 0),
        ("mls_quantize_rows", "serve moonshot attn w^T (2048, 2048)", q(2048, 2048), 0),
        ("mls_quantize_rows", "serve llama4-scout shared w_up^T (8192, 5120)", q(8192, 5120), 0),
        ("mls_quantize_rows", "serve seamless w_up^T (4096, 1024)", q(4096, 1024), 0),
        ("mls_quantize_given_sg", "stage1_fwd_cols (131072, 256) c", q(131072, 256, "c"), 1),
        ("mls_quantize_given_sg", "stage1_wgrad_colsT (144, 131072) c", q(144, 131072, "c"), 0),
        ("mls_quantize_given_sg", "implicit none codes (69632, 34) none",
         at.TuneSpec("quantize", (69632, 34), F, 34, "none"), 0),
        ("mls_quantize_given_sg", "stage1_fwd_cols (131072, 256) none", q(131072, 256, "none"), 0),
        ("mls_matmul", "stage1_fwd 131072 x 144 x 16", gm(131072, 144, 16), 0),
        ("mls_matmul", "stage1_wgrad 144 x 131072 x 16", gm(144, 131072, 16), 1),
        ("mls_matmul", "serve chatglm3 decode 4 x 4096 x 13696", gm(4, 4096, 13696), 0),
        ("mls_matmul", "serve chatglm3 decode 4 x 13696 x 4096", gm(4, 13696, 4096), 0),
        ("mls_matmul", "serve chatglm3 prefill 512 x 4096 x 13696", gm(512, 4096, 13696), 0),
        ("mls_matmul", "lm_train chatglm3 w_up fwd 8192 x 4096 x 13696", gm(8192, 4096, 13696), 0),
        ("mls_matmul", "lm_train chatglm3 w_up wgrad 4096 x 8192 x 13696",
         gm(4096, 8192, 13696), 0),
        ("mls_matmul", "lm_train chatglm3 wk fwd 8192 x 4096 x 256", gm(8192, 4096, 256), 0),
        ("mls_matmul", "serve moonshot attn decode 4 x 2048 x 2048", gm(4, 2048, 2048), 0),
        ("mls_matmul", "serve llama4-scout shared decode 4 x 5120 x 8192", gm(4, 5120, 8192), 0),
        ("mls_matmul", "serve llama4-scout shared decode 4 x 8192 x 5120", gm(4, 8192, 5120), 0),
        ("mls_matmul", "serve seamless w_down decode 4 x 4096 x 1024", gm(4, 4096, 1024), 0),
    ]
    for stage, (xs, ws, s) in STAGE.items():
        g = ic.conv_geometry(xs, ws, (s, s), "SAME")
        for grouping in ("nc", "c", "n"):
            rows.append(("implicit_conv", f"stage{stage}_conv x {xs} w {ws} s{s} {grouping}",
                         at.TuneSpec("conv", ic.conv_tune_dims(g, 144), F, 144, grouping),
                         int(stage == 1 and grouping == "nc")))
    rows.append(("sabotage_overlap", "x (8, 16) @ w (16, 32)", None, 1))
    return rows


def bytes_and_ops(kernel: str, spec) -> tuple[int, int]:
    """What the function must move and compute: inputs read and outputs
    written once; int8 MACs x 2 for the GEMMs (K padded to k_block)."""
    if kernel == "sabotage_overlap":
        return (8 * 16 + 16 * 32 + 8 * 32) * 4, 0
    if spec.kind == "quantize":  # x and its rounding byte in, codes, group and tensor scales out
        M, K = spec.shape
        width = {"nc": spec.k_block, "c": spec.k_block, "n": K, "none": K}[spec.grouping]
        n_sg = M * (K // width) if spec.grouping in ("nc", "n") else K // width
        return 6 * M * K + 4 * n_sg + 4, 0
    if spec.kind == "gemm":
        M, K, N = spec.shape
        kp = -(-K // spec.k_block) * spec.k_block
        g = kp // spec.k_block
        return (M + N) * kp + 4 * (M + N) * g + 4 * M * N + 8, 2 * M * N * kp
    geom = at._geom(spec)  # x, both rounding bytes and the weight in, the output out
    m0, k0, o = geom.m0, geom.k0, geom.o
    return (4 * geom.n * geom.c * geom.h * geom.w + m0 * k0 + o * k0 + 4 * o * k0
            + 4 * m0 * o), 2 * m0 * k0 * o


def cuda_ms(fn) -> float:
    return at.cuda_ms(fn, n=20, warmup=3)


def kernel_ms(fn, names, iters: int = 10) -> float | None:
    """Mean device ms per call in kernels named like ``names``; None unless
    every call's kernels were recorded (the profiler drops a session's
    first kernels late in a long process: PROFILER_PAD small ones go
    first)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    pad = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILER_PAD):
            pad.add_(1)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    if not times or len(times) % iters:
        return None
    return sum(times) / 1e3 / iters


def _call(kernel: str, spec, config, device: str):
    if kernel == "sabotage_overlap":
        from repro_torch.kernels.sabotage import sabotage_overlap_matmul

        gen = torch.Generator(device=device).manual_seed(0)
        x = torch.randn((8, 16), generator=gen, device=device)
        w = torch.randn((16, 32), generator=gen, device=device)
        return lambda: sabotage_overlap_matmul(x, w)
    return at.config_call(spec, config, device=device)


def bench_row(kernel: str, label: str, spec, main: int, device: str) -> dict:
    cuda = device == "cuda"
    if spec is None:  # K5: not tuned
        default = tuned = None
        cached = False
    else:
        default = at.default_block_config(spec)
        tuned = at.resolve_block_config(spec.kind, spec.shape, spec.fmt, spec.grouping,
                                        k_block=spec.k_block, device=device)
        cached = at.get_cache().get(spec.key()) is not None and at.get_cache().device == \
            at.device_name(device)
    fn = _call(kernel, spec, default, device)
    fn()  # runs here on the CPU too (the plain versions)
    default_ms = (cuda_ms(fn), at.device_ms(fn)) if cuda else (None, None)
    if tuned == default:
        tuned_ms, tuned_fn = default_ms, fn
    else:
        tuned_fn = _call(kernel, spec, tuned, device)
        tuned_fn()
        tuned_ms = (cuda_ms(tuned_fn), at.device_ms(tuned_fn)) if cuda else (None, None)
    nbytes, ops = bytes_and_ops(kernel, spec)
    bound_bytes, bound_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    row = {"kernel": kernel, "shape": label, "spec": spec.key() if spec else None,
           "default": {"config": default.to_json() if default else "fixed",
                       "ms": default_ms[0], "device_ms": default_ms[1]},
           "tuned": {"config": tuned.to_json() if tuned else "fixed", "ms": tuned_ms[0],
                     "device_ms": tuned_ms[1], "cached": cached,
                     "same_as_default": tuned == default},
           "kernel_ms": kernel_ms(tuned_fn, DEVICE_KERNELS[kernel]) if cuda else None,
           "bound_ms": max(bound_bytes, bound_ops),
           "bound_by": "bytes" if bound_bytes >= bound_ops else "operations",
           "bytes": nbytes, "ops": ops}
    if main:
        row["launches_per_step"] = MAIN_LAUNCHES[kernel]
    if spec is not None and spec.kind == "conv":
        geom = at._geom(spec)
        row["bytes_model"] = {
            "implicit": ic.implicit_conv_bytes(geom, spec.k_block, grouping=spec.grouping,
                                               bn=tuned.bn or None),
            "im2col": ic.im2col_conv_bytes(geom, spec.k_block)}
    del fn, tuned_fn
    if cuda:
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--small", action="store_true", help="tiny shapes (for the CPU)")
    ap.add_argument("--rows", default=None, help="only rows whose label contains this")
    ap.add_argument("--json", default="BENCH_torch_kernels.json")
    args = ap.parse_args(argv)
    device = resolve_device(args.device).type
    smi = nvidia_smi() if device == "cuda" else None
    if smi:
        print(smi)
    rows = []
    for kernel, label, spec, main_row in _rows(args.small):
        if args.rows and args.rows not in label:
            continue
        rows.append(bench_row(kernel, label, spec, main_row, device))
        r = rows[-1]
        print(json.dumps({k: r[k] for k in ("kernel", "shape", "default", "tuned", "kernel_ms",
                                            "bound_ms", "bound_by")}), flush=True)
    ratio = [r["tuned"]["device_ms"] / r["default"]["device_ms"] for r in rows
             if r["tuned"]["device_ms"] and r["default"]["device_ms"]]
    extra = {"device": at.device_name(device), "cache_device": at.get_cache().device,
             "tuned_over_default_device_ms_median": statistics.median(ratio) if ratio else None}
    write_json(args.json, make_payload("torch_kernel_bench", rows, quick=args.small,
                                       extra=extra, device=device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
