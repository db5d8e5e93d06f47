"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero, with no result line):
  1. device   - require CUDA; print nvidia-smi's name and power limit.
  2. build    - build the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels  - run every kernel at the ResNet-20 main path's shapes on the
                card and hold it bit-identical (tolerance 0) to its plain
                PyTorch version on the same inputs; time both with CUDA
                events (median of 20 after warm-up).
  4. train    - the main path: 5 SGD steps of ResNet-20 at full width
                (CIFAR 32x32, batch 128, <2,4>, k_block 128, grouping "nc",
                stochastic rounding) through repro_torch.train; losses must
                be finite and every step must launch the quantize kernel
                120 times and the GEMM kernel 60 times (20 quantized convs x
                6 operands / x 3 GEMMs).  Then 2 steps with grouping "c"
                (paper Table IV), the path of the given-scale kernel.
  5. trace    - 3 more main-path steps under torch.profiler: device time
                by kernel and the device's idle share of the step.
  6. agree    - a small ResNet-20 train step on the card (kernels) agrees
                with the same step on the CPU (plain versions).
The line before the last is {"kernels": [...]}, the last line
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core rate
BATCH, HW, K_BLOCK = 128, 32, 128
TRAIN_STEPS = 5
# the shape each kernel is reported at on the {"kernels": ...} line (all
# timed shapes are in chiprun_out/chip_smoke.json)
REPORTED_SHAPE = {"mls_quantize_rows": "stage1_fwd_cols", "mls_quantize_given_sg": "stage1_fwd_cols",
                  "mls_matmul": "stage1_wgrad"}
KERNELS = {
    "mls_quantize_rows": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                          "src/repro/kernels/mls_quantize.py:107"),
    "mls_quantize_given_sg": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                              "src/repro/kernels/mls_quantize.py:123"),
    "mls_matmul": ("src/repro_torch/kernels/csrc/mls_matmul.cu",
                   "src/repro/kernels/mls_matmul.py:104"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_abs_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


def quantize_operand(rows: int, cols: int, pad_to: int, gen):
    """A float operand like the main path's: ``cols`` real columns of
    normal data, zero-padded to ``pad_to`` (qd_gemm's K padding)."""
    import torch

    x = torch.zeros((rows, pad_to), device="cuda")
    x[:, :cols] = torch.randn((rows, cols), generator=gen, device="cuda")
    return x


def phase_kernels(results: dict) -> list[dict]:
    """Every kernel against its plain version at the main path's shapes."""
    import torch

    from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_matmul import sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    n_hw = BATCH * HW * HW
    # quantize operands: the stage-1 forward activation (cols, K 144 padded
    # to 256) and the stage-1 weight-gradient operand cols.T (144, N*OH*OW)
    q_shapes = {"stage1_fwd_cols": (n_hw, 144, 256), "stage1_wgrad_colsT": (144, n_hw, n_hw)}
    checks, timed = [], {}
    for sname, (rows, real, padded) in q_shapes.items():
        x = quantize_operand(rows, real, padded, gen)
        r = rounding_bytes(x.shape, gen, x.device)
        for fmt in (FMT_IMAGENET, FMT_CIFAR):
            for grouping in ("nc", "n", "c", "none"):
                got = mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r, grouping)
                want = quantize_ref(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r, grouping)
                torch.cuda.synchronize()
                same = all(torch.equal(a, b) for a, b in zip(got, want))
                err = max(max_abs_err(a, b) for a, b in zip(got, want))
                kernel = "mls_quantize_rows" if grouping in ("nc", "n") else "mls_quantize_given_sg"
                checks.append(dict(kernel=kernel, shape=sname, fmt=str(fmt),
                                   grouping=grouping, identical=same, max_abs_err=err))
                key = (kernel, sname, str(fmt), grouping)
                if fmt is FMT_IMAGENET and grouping in ("nc", "c"):
                    M, K = x.shape
                    n_sg = got[1].numel()
                    timed[key] = dict(
                        ms=cuda_ms(lambda: mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r,
                                                        grouping)),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, K_BLOCK, GS_FMT_DEFAULT,
                                                              r, grouping), iters=20),
                        bytes=M * K * 6 + n_sg * 4 + 4, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
        del x, r
    # GEMMs: stage-1 forward (cols @ wmat), stage-1 wgrad (cols.T @ e2d),
    # stage-3 dgrad (e2d @ wmat); (M, K real, K padded, N)
    g_shapes = {
        "stage1_fwd": (n_hw, 144, 256, 16),
        "stage1_wgrad": (144, n_hw, n_hw, 16),
        "stage3_dgrad": (BATCH * 8 * 8, 64, 128, 576),
    }
    for sname, (M, real, K, N) in g_shapes.items():
        x = quantize_operand(M, real, K, gen)
        wt = quantize_operand(N, real, K, gen)  # the weight, quantized as (N, K)
        for grouping in ("nc", "c", "n", "none"):
            xc, xsg, xst = quantize_ref(x, FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT,
                                        rounding_bytes(x.shape, gen, x.device), grouping)
            wc, wsgT, wst = quantize_ref(wt, FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT,
                                         rounding_bytes(wt.shape, gen, wt.device), grouping)
            args = (xc, xsg, xst, wc.t(), wsgT.t(), wst, FMT_IMAGENET, K_BLOCK)
            got = mls_matmul(*args, grouping)
            want = mls_matmul_ref(*args)
            torch.cuda.synchronize()
            err = max_abs_err(got, want)
            checks.append(dict(kernel="mls_matmul", shape=sname, fmt="<2,4>",
                               grouping=grouping, identical=torch.equal(got, want),
                               max_abs_err=err, finite=bool(torch.isfinite(got).all())))
            if grouping == "nc":
                xs_shape, ws_shape = sg_shapes(grouping, M, N, K // K_BLOCK)
                timed[("mls_matmul", sname, "<2,4>", grouping)] = dict(
                    ms=cuda_ms(lambda: mls_matmul(*args, grouping)),
                    plain_ms=cuda_ms(lambda: mls_matmul_ref(*args),
                                     iters=20, warmup=1),
                    bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                    + 4 * M * N + 8,
                    ops=2 * M * N * K, max_abs_err=err,
                    shape=f"{sname} ({M}x{K}x{N}) {grouping} <2,4>")
        del x, wt
    results["kernel_checks"] = checks
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, shape=t["shape"], ms=t["ms"], plain_ms=t["plain_ms"],
                         bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         max_abs_err=t["max_abs_err"]))
        print(json.dumps({"timing": rows[-1]}))
    results["kernel_times"] = rows
    bad = [c for c in checks if not c["identical"]]
    for c in checks:
        print(json.dumps(c))
    if bad:
        raise AssertionError(f"{len(bad)} kernel results differ from their plain versions")
    return rows


def phase_train(results: dict) -> dict[str, int]:
    """The main path, then the given-scale path; returns launches per kernel."""
    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.loop import train_variant

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    reset_launch_counts()
    res = train_variant("mls<2,4>", qcfg, TRAIN_STEPS, width=1.0, hw=HW, batch=BATCH,
                        device="cuda")
    main_counts = launch_counts()
    results["train"] = dict(losses=res.losses, accs=res.accs, step_s=res.step_s,
                            launches_per_step=res.launches, launches=main_counts)
    step_ms = statistics.median(res.step_s[1:]) * 1e3
    print(f"train: losses {res.losses} median step after step 1 {step_ms:.3f} ms "
          f"launches {main_counts}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"non-finite loss: {res.losses}")
    for i, per in enumerate(res.launches):
        if per["mls_quantize_rows"] != 120 or per["mls_matmul"] != 60:
            raise AssertionError(f"step {i}: launches {per}, expected 120 quantize and 60 GEMM")

    # paper Table IV grouping "c": the given-scale quantize kernel's path
    qc = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="c", stochastic=True)
    reset_launch_counts()
    res_c = train_variant("mls<2,4> c", qc, 2, width=1.0, hw=HW, batch=BATCH, device="cuda")
    c_counts = launch_counts()
    results["train_grouping_c"] = dict(losses=res_c.losses, launches=c_counts)
    print(f"train grouping c: losses {res_c.losses} launches {c_counts}")
    if not all(math.isfinite(v) for v in res_c.losses) or c_counts["mls_quantize_given_sg"] != 240:
        raise AssertionError(f"grouping c path: losses {res_c.losses} launches {c_counts}")
    return {**main_counts, "mls_quantize_given_sg": c_counts["mls_quantize_given_sg"]}


def phase_trace(results: dict) -> None:
    """Where a main-path step's time goes: 3 more steps under
    torch.profiler; device time by kernel, the port's kernels against the
    rest, and the device's idle share of the host-clock step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.train.loop import train_variant

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    steps = 3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        res = train_variant("traced", qcfg, steps, width=1.0, hw=HW, batch=BATCH,
                            device="cuda", log=lambda *_: None)
        torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    ours = ("quantize_groups_warp", "quantize_groups_block", "quantize_given_sg",
            "mls_matmul_kernel")
    ours_ms = sum(v for k, v in by_name.items() if any(o in k for o in ours))
    device_ms = sum(by_name.values())
    host_ms = sum(res.step_s) * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    trace = dict(steps=steps, host_ms_per_step=host_ms / steps,
                 device_ms_per_step=device_ms / steps,
                 port_kernels_ms_per_step=ours_ms / steps,
                 other_device_ms_per_step=(device_ms - ours_ms) / steps,
                 device_idle_share=1.0 - device_ms / host_ms if host_ms else None,
                 top_kernels_ms_per_step=[(k[:90], v / steps) for k, v in top])
    results["trace"] = trace
    print(json.dumps({"trace": trace}))
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")


def phase_agree(results: dict) -> None:
    """One small train step on the card agrees with the CPU's plain run."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.models.cnn import CNNConfig, init_resnet

    cfg = CNNConfig("resnet20", width_mult=0.25, in_hw=8)
    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=32, stochastic=False)
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn((4, 3, 8, 8), generator=gen), torch.randint(0, 10, (4,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_resnet(cfg, seed=3, device=dev)
        logits = model(x.to(dev), qcfg)
        loss = F.cross_entropy(logits, y.to(dev))
        loss.backward()
        out[dev] = (float(loss.detach()), logits.detach().cpu(),
                    {n: p.grad.detach().cpu() for n, p in model.named_parameters()})
    (l_cpu, z_cpu, g_cpu), (l_gpu, z_gpu, g_gpu) = out["cpu"], out["cuda"]
    cos, grad_rel = 1.0, 0.0
    for n in g_cpu:
        a, b = g_gpu[n].flatten().double(), g_cpu[n].flatten().double()
        cos = min(cos, float(a @ b / (a.norm() * b.norm())))
        grad_rel = max(grad_rel, float((a - b).norm() / b.norm()))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    z_err = max_abs_err(z_cpu, z_gpu)
    results["agree"] = dict(loss_cpu=l_cpu, loss_gpu=l_gpu, loss_rel=rel, min_grad_cos=cos,
                            max_grad_rel=grad_rel, logits_max_abs=z_err)
    print(f"agree: {results['agree']}")
    # tolerance: the quantized convs are bit-exact, but the stem conv, BN
    # and the classifier reduce in another order on the card, so the last
    # bits differ (seen: loss equal, logits within 7.2e-7, fp32 gradient
    # cosine above 1 - 1.2e-7); each limit is far below what a wrong
    # kernel or a flipped code gives
    if not (rel <= 1e-5 and z_err <= 1e-5 and cos >= 1 - 1e-5 and grad_rel <= 1e-4
            and torch.isfinite(z_gpu).all()):
        raise AssertionError(f"card and CPU disagree: {results['agree']}")


def main() -> int:
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke test needs a GPU")
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside {Path(__file__).name}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    smi_line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "nvidia-smi failed"
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line}")

    from repro_torch.kernels import build
    from repro_torch.runtime import resolve_device

    resolve_device("cuda")  # TF32 off
    results: dict = {"nvidia_smi": smi_line, "torch": torch.__version__,
                     "cuda": torch.version.cuda}
    failures = []
    t0 = time.perf_counter()
    try:
        build.library()
        results["build_s"] = time.perf_counter() - t0
        print(f"build: {results['build_s']:.1f} s ({build.library_path().name})")
        log = build.library_path().with_suffix(".log")
        if log.exists():
            results["ptxas"] = [ln for ln in log.read_text().splitlines()
                                if "registers" in ln or "spill" in ln]
    except Exception:
        traceback.print_exc()
        fail("kernel build failed")

    rows, launches = [], {}
    for name, phase in (("kernels", phase_kernels), ("train", phase_train),
                        ("trace", phase_trace), ("agree", phase_agree)):
        t = time.perf_counter()
        try:
            out = phase(results)
            if name == "kernels":
                rows = out
            elif name == "train":
                launches = out
        except Exception:
            traceback.print_exc()
            failures.append(name)
        results[f"{name}_s"] = time.perf_counter() - t
        print(f"phase {name}: {'FAILED' if name in failures else 'ok'} "
              f"({results[f'{name}_s']:.1f} s)")

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    if failures:
        fail(f"phases failed: {failures}")
    kernels = []
    for r in rows:
        if not r["shape"].startswith(REPORTED_SHAPE[r["name"]]):
            continue
        source, replaces = KERNELS[r["name"]]
        kernels.append(dict(name=r["name"], route="cuda", source=source, replaces=replaces,
                            launches=launches.get(r["name"], 0), max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None, shape=r["shape"]))
    missing = [k for k in KERNELS if not any(r["name"] == k for r in kernels)]
    if missing or any(launches.get(k, 0) == 0 for k in KERNELS):
        fail(f"kernels not timed or not launched by their path: {missing} {launches}")
    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
