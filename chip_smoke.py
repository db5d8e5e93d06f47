"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure makes the script exit non-zero, with no result line):
  1. device   - require CUDA; print nvidia-smi's name and power limit.
  2. build    - build the CUDA kernels from src/repro_torch/kernels/csrc.
  3. kernels  - run every kernel at the ResNet-20 main paths' shapes on the
                card and hold it bit-identical (tolerance 0) to its plain
                PyTorch version on the same inputs; time both with CUDA
                events (median of 20 after warm-up), and the kernels alone
                with torch.profiler.  K1 at the stage-1 forward and
                weight-gradient operands, four groupings, <2,4> and <2,1>.
                K3 at the weight gradients of all three stages, the
                stage-1 and stage-3 forwards, the stage-3 data gradient, a
                ragged shape and k_block 144, four groupings, on the plan
                matmul_plan picks and on the other variant (walk / ordered
                split); <3,1> on the int32 body.  K2 ("c", "none") also at
                the implicit "none" path's (N*C*Hp, Wp) = (69632, 34)
                operand, its code pass alone there, and an all-zero
                operand.  The implicit conv (K4) runs at its stage-1,
                stage-2 (stride 2) and stage-3 convs, four groupings (the
                scales of every grouping made by K4's own passes),
                <2,4> and <2,1>, <3,1> (int32 body) at stage 1, and at two
                zoo convs the dispatch sends to it at k_block 128
                (GoogleNet's 3b 1x1, ResNet-18's stride-2 projection); it
                is held to the im2col route too and timed beside it ("c"
                and "n" also beside the PyTorch glue that made their
                scales before).  K1 ("nc", "n") on both operands and K3
                (both plans) of the three GEMMs of four zoo convs at the
                zoo phase's shapes (ZOO_CONVS: ResNet-18's stage-1 3x3,
                ResNet-34's stage-4 3x3, GoogleNet's 4b 3x3, VGG-16's
                last 3x3).  K1 ("nc", "n") and K4 (four groupings) with a
                NaN input against the plain versions on the CPU.
  4. train    - the main path: 5 SGD steps of ResNet-20 at full width
                (CIFAR 32x32, batch 128, <2,4>, k_block 128, grouping "nc",
                stochastic rounding) through repro_torch.train; losses must
                be finite and every step must launch the quantize kernel
                120 times and the GEMM kernel 60 times (20 quantized convs x
                6 operands / x 3 GEMMs), and K4 never (no conv is legal
                for it at k_block 128).  Then 2 steps with grouping "c"
                (paper Table IV), the path of the given-scale kernel.  Then
                the implicit path: 5 steps at k_block 144 (cb = 16 channels
                x 3x3 taps), where the 18 3x3 convs run their forward
                through K4; then 2 steps of it with grouping "none" and
                nearest rounding (K4's given-scale prologue and the weight
                gradient that reuses the forward codes).  Each path's
                launches per step must equal what the dispatch gives for
                its 20 convs (expected_launches).
  5. trace    - 3 more steps of the main path, the implicit path and the
                grouping-"c" path under torch.profiler: device time by
                kernel and the device's idle share of the step.
  6. agree    - a small ResNet-20 train step on the card (kernels) agrees
                with the same step on the CPU (plain versions), at k_block
                32 (im2col) and at k_block 36 (every 3x3 conv implicit).
  7. audit    - the verifier's planted-overlap control K5 against its plain
                version: the blocks no program writes stay NaN, each element
                of a twice-written block is bit-identical to one of its two
                writers' ordered fp32 sums (the race picks which), and the
                store probe counts [2, 0, 2, 0] by block column, the table
                the verifier derives from K5's launch spec; timed.  Then
                `python -m repro_torch.analysis.audit --graph train
                --kernels --gate` at full width (one step at k_block 128,
                one at 144): it must pass, with quantized fraction >= 0.99
                on both paths and every recorded launch spec of K1-K4
                proven; `--graph serve --kernels --gate` (one quantized
                decode step of qwen2-72b's smoke config, batch 4, cache
                128): it must pass at the closed form's fraction 0.619048
                with its 42 launches proven; and each of the four
                --sabotage modes must fail the gate naming its violation
                (overlap_write runs K5 once).
  8. zoo      - VGG-16 and GoogleNet (CIFAR: 32x32, 10 classes, batch 128)
                and ResNet-18/34 (ImageNet: 224x224, 1000 classes, batch
                64) at full width on the quantized backend (<2,4>, k_block
                128, "nc", stochastic): 2 steps each with finite losses
                and each step's launches equal to the dispatch's count over
                the model's quantized convs as OpTrace lists them (K1 and
                K3 on all, K4 on the 1x1 convs with 128 | C); step time,
                peak device memory and one traced step.
  9. fake_quant - the fake-quant backend: 5 steps of full-width ResNet-20,
                batch 128, <2,1>, on the card, with finite losses and no
                launch of the port's kernels (the JAX package runs this
                path without Pallas: the quantizer is PyTorch code, the
                convs fp32 convs); a traced step; a small step on the card
                that agrees with the CPU.
  10. driver  - examples/torch_train_cifar_lowbit.py for 3 full-width steps
                (fp32, <2,4>, <2,1>, quantized backend); a checkpoint saved
                on the card and restored on the card and on the CPU, every
                tensor equal; the run resumed from it takes the next step
                with the uninterrupted run's loss.
  11. serve   - the LM serving path through repro_torch.serve.ServeEngine
                on the quantized kernels (quant_backend "pallas": K1 on
                both operands of every linear, then K3; nearest rounding),
                random weights, bf16 compute, batch 4 and 16 new tokens:
                chatglm3-6b at full width and depth (6.24 G fp32
                parameters, 128-token prompts), mamba2-370m at full width
                and depth (320-token prompts: SSD chunk 160 by the divisor
                rule), zamba2-7b at full width cut to 12 layers with a
                window of 136 (the ring buffer wraps), the MoEs at full
                width, moonshot-v1-16b-a3b cut to 16 layers (64 experts,
                top 6: tokens drop at prefill's capacity 13) and
                llama4-scout-17b-a16e to 4 (top 1 and a shared expert),
                and seamless-m4t-medium at full width and depth (its
                encoder over 1024 random frontend frames per prompt).
                Every logit finite; the launches of a whole generate, and
                of each prefill and decode step, equal the closed form
                (serve_linears: 196 K3 / 392 K1 per step on chatglm3-6b,
                96 / 192 on mamba2-370m, 38 / 76 on the cut zamba2-7b, 64
                / 128 on the cut moonshot (attention only: the routed
                experts run fake-quant GEMMs, as in the JAX package), 28 /
                56 on the cut llama4-scout, 96 / 192 per decode step and
                168 / 336 per prefill on seamless); prefill ms, decode ms
                per step (median) and tokens/s, one decode step traced
                (device busy, idle share, K1 and K3 ms, the routed experts'
                fake-quant ms), peak memory.  K1 and K3 (both plans) held
                bit-identical to their plain versions at the serving GEMMs
                (serve_gemms: SERVE_GEMMS and the new models' distinct
                shapes at decode and prefill) and the decode ones timed;
                what re-coding chatglm3-6b's weights costs per step
                (qd_gemm's transposed copy, the rounding-byte fill, K1),
                timed; the smoke configs of the six models on the card
                against the CPU (logits within 1e-3 of max(1,
                max|logit|), greedy tokens equal, launches the closed
                form).
  12. lm_train - LM training through repro_torch.train.make_train_step on
                the quantized kernels (quant_backend "pallas": K1 on both
                operands and K3 for the forward, data-gradient and
                weight-gradient GEMM of every linear, and once more for the
                forward that full remat recomputes), stochastic rounding,
                AdamW with the default cosine schedule, random weights, bf16
                compute, 4 steps each: chatglm3-6b at full width cut to 8 of
                its 28 layers at batch 2 x 4096 (train_4k's sequence),
                mamba2-370m at full width and depth at batch 4 x 1024,
                zamba2-7b at full width cut to 12 layers at batch 2 x 4096
                (the shared block runs twice, not remat'd),
                moonshot-v1-16b-a3b at full width cut to 4 layers at batch
                1 x 4096, and seamless-m4t-medium at full width and depth
                at batch 2 x 4096 over 4096 source frames.  Losses and grad
                norms finite; the weights unchanged by step 1 (lr 0) and
                moved by step 2; the launches of each step and of the run
                equal the closed form (lm_train_launches: 224 K3 / 448 K1
                per step on chatglm3-6b, 384 / 768 on mamba2-370m, 138 /
                276 on the cut zamba2-7b, 64 / 128 on the cut moonshot,
                768 / 1536 on seamless); one step traced (device busy,
                idle share, K1, K3, copies, the routed experts'
                fake-quant), peak memory, the attention, the LM head and
                an MoE layer's experts timed alone at the step's shapes;
                a microbatch-2
                step on chatglm3-6b (finite, twice the launches);
                mamba2-370m checkpointed after step 2 on the card, restored
                on the card, its step 3 bit-identical to the uninterrupted
                one.  K1 (stochastic, given bytes) and K3 (both plans)
                bit-identical to their plain versions at every distinct
                training GEMM of the five models (forward, data and weight
                gradient of each quantized linear at the run's T:
                lm_train_gemms), chatglm3-6b's nine timed, with
                the weight gradient's transposed copies; each step's time
                is train_step alone, its batch drawn and timed before it;
                the smoke configs' lm_loss and gradients
                (key None) on the card against the CPU (LM_TRAIN_AGREE),
                as run and with every quantizer fed the CPU run's
                operands (fed_operands).
  13. sweep   - the frontier sweep's chip grid (repro_torch.sweep.chip_grid:
                ResNet-20 at full width, CIFAR 32x32, batch 128, lr 0.05,
                40 SGD-momentum steps; fp32, <2,4>, <2,1> and <0,4> on
                fake_quant; <2,4> and <2,1> on the kernels ("pallas": K1/K3,
                120 / 60 launches a step); <2,1> on the kernels with
                grouping "c" and "none" (K2/K3)), through
                repro_torch.sweep.runner; finite losses, every step's
                launches the dispatch's count (none on fake_quant), step
                times (median of steps 2-40) and the frontier table; the
                gate against the committed chip entries of
                src/repro_torch/sweep/baselines/accuracy.json must pass and
                fail under both sabotage modes ("regress", "missing_cell");
                two cells run again must repeat their losses bit for bit
                (and the fp32 cell twice with cuDNN's default algorithms,
                reported); then
                benchmarks/torch_table2_accuracy.py (quick) on the card,
                every variant's loss finite.
The line before the last is {"kernels": [...]}: each kernel's `launches`
are its count on the training path (phase train; K5's in the audit's
overlap_write run), `serve_launches` its count per model of the serve
phase, `lm_train_launches` per model of the lm_train phase's 4-step
run, and `sweep_launches` its launches per step in each "pallas" cell of
the sweep's chip grid, each read from its own run.  The last line is
{"ok": true, "device": {...}}.  Details go to chiprun_out/chip_smoke.json
and the audit reports to chiprun_out/AUDIT_torch_*.json.
"""
from __future__ import annotations

import collections
import contextlib
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
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BATCH, HW, K_BLOCK = 128, 32, 128
K_BLOCK_IMPLICIT = 144  # 16 channels x 3x3 taps: legal for K4 on all 18 3x3 convs
TRAIN_STEPS = 5
PROFILER_PAD = 256  # kernels that open each kernel_ms session (see there)
# the shape each kernel is reported at on the {"kernels": ...} line (all
# timed shapes are in chiprun_out/chip_smoke.json)
REPORTED_SHAPE = {"mls_quantize_rows": "stage1_fwd_cols", "mls_quantize_given_sg": "stage1_fwd_cols",
                  "mls_matmul": "stage1_wgrad ", "implicit_conv": "stage1_conv",
                  "sabotage_overlap": "x (8, 16)"}
# device kernels (profiler names) of each C entry point
# (K2 "none" and "c" on one group take K1's quantize_amax as pass A)
DEVICE_KERNELS = {"mls_quantize_rows": ("quantize_amax", "quantize_groups_warp",
                                        "quantize_groups_block"),
                  "mls_quantize_given_sg": ("quantize_cols_amax", "quantize_cols_reduce",
                                            "quantize_scales", "quantize_codes",
                                            "quantize_amax"),
                  "mls_matmul": ("mls_matmul_walk", "mls_matmul_terms", "mls_matmul_sum"),
                  "implicit_conv": ("conv_amax", "implicit_conv_kernel", "conv_scale",
                                    "conv_win_amax", "conv_chan_amax", "conv_group_reduce",
                                    "conv_chan_scales")}
KERNELS = {
    "mls_quantize_rows": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                          "src/repro/kernels/mls_quantize.py:107"),
    "mls_quantize_given_sg": ("src/repro_torch/kernels/csrc/mls_quantize.cu",
                              "src/repro/kernels/mls_quantize.py:123"),
    "mls_matmul": ("src/repro_torch/kernels/csrc/mls_matmul.cu",
                   "src/repro/kernels/mls_matmul.py:104"),
    "implicit_conv": ("src/repro_torch/kernels/csrc/implicit_conv.cu",
                      "src/repro/kernels/implicit_conv.py:403"),
    "sabotage_overlap": ("src/repro_torch/kernels/csrc/sabotage_overlap.cu",
                         "src/repro/analysis/kernel_verify.py:730"),
}
# K4's shapes on the implicit path: (x shape, w shape, stride, k_block) --
# ResNet-20's stage convs at k_block 144, and two zoo convs that the
# dispatch sends to K4 at the paper's k_block 128: GoogleNet's 3b 1x1 branch
# (CIFAR, batch 128) and ResNet-18's stage-3 stride-2 projection (ImageNet,
# batch 64)
CONV_SHAPES = {
    "stage1_conv": ((BATCH, 16, 32, 32), (16, 16, 3, 3), (1, 1), K_BLOCK_IMPLICIT),
    "stage2_conv_s2": ((BATCH, 16, 32, 32), (32, 16, 3, 3), (2, 2), K_BLOCK_IMPLICIT),
    "stage3_conv": ((BATCH, 64, 8, 8), (64, 64, 3, 3), (1, 1), K_BLOCK_IMPLICIT),
    "googlenet_3b_1x1": ((BATCH, 256, 32, 32), (128, 256, 1, 1), (1, 1), K_BLOCK),
    "resnet18_proj_s2": ((64, 128, 28, 28), (256, 128, 1, 1), (2, 2), K_BLOCK),
}

# The zoo at full width: CIFAR size for VGG-16 and GoogleNet, ImageNet size
# for the ResNets.  arch: (hw, classes, batch)
ZOO = {"vgg16": (32, 10, 128), "googlenet": (32, 10, 128), "resnet18": (224, 1000, 64),
       "resnet34": (224, 1000, 64)}
# The zoo convs whose three GEMMs K1 and K3 are held to their plain
# versions at the zoo phase's own shapes (name: arch, which conv of its
# traced list): ResNet-18's stage-1 3x3 (M 200704; the weight gradient's
# 1568 scaling groups give K3's largest split workspace), ResNet-34's
# stage-4 3x3 (K 4608, N 512; its data gradient N 4608), GoogleNet's 4b
# 3x3 (C 112: K 1008 padded to 1024, N 224) and VGG-16's last 3x3 (M 512)
ZOO_CONVS = {
    "resnet18_stage1": ("resnet18", lambda g: g.c == 64 and g.kh == 3 and g.h == 56),
    "resnet34_stage4": ("resnet34", lambda g: g.k0 == 4608),
    "googlenet_4b_3x3": ("googlenet", lambda g: g.c == 112 and g.kh == 3),
    "vgg16_conv5": ("vgg16", lambda g: g.h == 2),
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


def kernel_ms(fn, name, iters: int = 10) -> float | None:
    """Mean device time per call of ``fn`` spent in kernels whose name
    contains ``name`` (or one of a tuple of names; torch.profiler), without
    the wrapper's other work.  Late in a long process (after the traced
    training steps) the profiler has dropped the first kernels of a
    session, so each session opens with PROFILER_PAD small kernels of no
    interest; and the reading is None unless every call's kernels were
    recorded (a count that is a multiple of ``iters``), never a time too
    small."""
    import torch
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
    names = (name,) if isinstance(name, str) else name
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and any(n in e.name for n in names)]
    if not times or len(times) % iters:
        return None
    return sum(times) / 1e3 / iters


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

    from repro_torch.kernels import mls_quantize, rounding_bytes
    from repro_torch.kernels.ref import quantize_ref

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
                if fmt is FMT_IMAGENET and grouping in ("nc", "c", "none"):
                    M, K = x.shape
                    n_sg = got[1].numel()
                    timed[key] = dict(
                        ms=cuda_ms(lambda: mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT, r,
                                                        grouping)),
                        kernel_ms=kernel_ms(lambda: mls_quantize(x, fmt, K_BLOCK, GS_FMT_DEFAULT,
                                                                 r, grouping),
                                            DEVICE_KERNELS[kernel]),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, K_BLOCK, GS_FMT_DEFAULT,
                                                              r, grouping), iters=20),
                        bytes=M * K * 6 + n_sg * 4 + 4, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
        del x, r
    checks += k2_checks(gen, timed)
    checks += matmul_checks(gen, timed)
    checks += implicit_conv_checks(gen, timed)
    checks += zoo_checks(gen, timed)
    checks += nan_checks()
    results["kernel_checks"] = checks
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, shape=t["shape"], ms=t["ms"], plain_ms=t["plain_ms"],
                         bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         max_abs_err=t["max_abs_err"]))
        rows[-1].update({k: t[k] for k in ("im2col_ms", "kernel_ms", "plan", "other_plan",
                                           "other_ms", "other_kernel_ms", "glue_ms") if k in t})
        print(json.dumps({"timing": rows[-1]}))
    results["kernel_times"] = rows
    bad = [c for c in checks if not c["identical"] or not c.get("equals_im2col", True)]
    for c in checks:
        print(json.dumps(c))
    if bad:
        raise AssertionError(f"{len(bad)} kernel results differ from their plain versions")
    return rows


# K2's own shapes besides the stage-1 operands: the implicit "none" path's
# code operand (N*C*Hp, Wp) of the stage-1 input, and an all-zero operand
K2_SHAPES = {"none_codes_NCHp_Wp": (BATCH * 16 * 34, 34), "zeros": (4096, 256)}


def k2_checks(gen, timed: dict) -> list[dict]:
    """K2 at K2_SHAPES against its plain version: mls_quantize "c" and
    "none" (k_block = the width at (69632, 34), 128 on the zeros), <2,4>
    and <2,1>; and the code pass alone (quantize_given_scales) as the
    implicit "none" path calls it on the padded input, against a given
    tensor scale.  The (69632, 34) calls are timed."""
    import torch

    from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_quantize import quantize_given_scales
    from repro_torch.kernels.ref import element_codes_ref, quantize_ref

    checks = []
    for sname, (M, K) in K2_SHAPES.items():
        x = (torch.zeros((M, K), device="cuda") if sname == "zeros"
             else torch.randn((M, K), generator=gen, device="cuda"))
        r = rounding_bytes(x.shape, gen, x.device)
        kb = K if sname != "zeros" else K_BLOCK
        for fmt in (FMT_IMAGENET, FMT_CIFAR):
            for grouping in ("c", "none"):
                run = lambda: mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, r, grouping)  # noqa: E731
                got = run()
                want = quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, r, grouping)
                torch.cuda.synchronize()
                err = max(max_abs_err(a, b) for a, b in zip(got, want))
                checks.append(dict(kernel="mls_quantize_given_sg", shape=sname, fmt=str(fmt),
                                   grouping=grouping, identical=all(
                                       torch.equal(a, b) for a, b in zip(got, want)),
                                   max_abs_err=err, s_t=float(got[2])))
                if sname == "zeros" and float(got[2]) != 1.0:
                    checks[-1]["identical"] = False
                if fmt is FMT_IMAGENET and grouping == "none" and sname != "zeros":
                    timed[("mls_quantize_given_sg", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(run), kernel_ms=kernel_ms(
                            run, DEVICE_KERNELS["mls_quantize_given_sg"]),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, r,
                                                              grouping)),
                        bytes=M * K * 6 + 8, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
        if sname == "zeros":
            continue
        # the code pass alone: against the tensor scale of a larger tensor
        s_t = (x.abs().amax() * 1.5).reshape(())
        ones = torch.ones((1, 1), device="cuda")
        nearest = rounding_bytes(x.shape, None, x.device)
        run = lambda: quantize_given_scales(x, FMT_IMAGENET, s_t, ones, K, nearest)  # noqa: E731
        got = run()
        want = element_codes_ref(x, nearest, s_t * ones, FMT_IMAGENET)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        checks.append(dict(kernel="mls_quantize_given_sg", shape=f"{sname} code pass",
                           fmt=str(FMT_IMAGENET), grouping="none (given s_t)",
                           identical=torch.equal(got, want), max_abs_err=err))
        timed[("mls_quantize_given_sg", sname, "code pass")] = dict(
            ms=cuda_ms(run), kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_given_sg"]),
            plain_ms=cuda_ms(lambda: element_codes_ref(x, nearest, s_t * ones, FMT_IMAGENET)),
            bytes=M * K * 6 + 8, ops=0, max_abs_err=err,
            shape=f"{sname} code pass ({M}, {K}) none, given s_t {FMT_IMAGENET}")
        del x, r
    return checks


# K3's shapes: (M, K real, K padded, N, k_block) -- forward (cols @ wmat),
# weight gradient (cols.T @ e2d), data gradient (e2d @ wmat.T) of
# full-width ResNet-20 at batch 128, K padded as qd_gemm pads it
GEMM_SHAPES = {
    "stage1_fwd": (BATCH * HW * HW, 144, 256, 16, K_BLOCK),
    "stage1_wgrad": (144, BATCH * HW * HW, BATCH * HW * HW, 16, K_BLOCK),
    "stage2_wgrad": (288, BATCH * 16 * 16, BATCH * 16 * 16, 32, K_BLOCK),
    "stage3_wgrad": (576, BATCH * 8 * 8, BATCH * 8 * 8, 64, K_BLOCK),
    "stage3_fwd": (BATCH * 8 * 8, 576, 640, 64, K_BLOCK),
    "stage3_dgrad": (BATCH * 8 * 8, 64, 128, 576, K_BLOCK),
    "ragged": (4099, 300, 384, 37, K_BLOCK),
    "kb144_stage1_wgrad": (144, BATCH * HW * HW, 131184, 16, K_BLOCK_IMPLICIT),
    "kb144_stage1_dgrad": (BATCH * HW * HW, 16, 144, 144, K_BLOCK_IMPLICIT),
}
FMT_INT32 = (3, 1)  # fractions up to 192: K3's int32 body


def matmul_checks(gen, timed: dict) -> list[dict]:
    """K3 against mls_matmul_ref at GEMM_SHAPES: four groupings at <2,4>
    on the plan matmul_plan picks and on the other variant; <3,1> (the
    int32 body) with grouping "nc" on both variants where k_block 128
    allows it.  The "nc" <2,4> call of each shape is timed on both plans,
    <3,1> at the stage-1 weight gradient."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat
    from repro_torch.kernels import mls_matmul, rounding_bytes
    from repro_torch.kernels.mls_matmul import matmul_plan, sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    checks = []
    for sname, (M, real, K, N, kb) in GEMM_SHAPES.items():
        x = quantize_operand(M, real, K, gen)
        wt = quantize_operand(N, real, K, gen)  # the weight, quantized as (N, K)
        cases = [(FMT_IMAGENET, g) for g in ("nc", "c", "n", "none")]
        if kb == K_BLOCK:
            cases.append((EMFormat(*FMT_INT32), "nc"))
        for fmt, grouping in cases:
            xc, xsg, xst = quantize_ref(x, fmt, kb, GS_FMT_DEFAULT,
                                        rounding_bytes(x.shape, gen, x.device), grouping)
            wc, wsgT, wst = quantize_ref(wt, fmt, kb, GS_FMT_DEFAULT,
                                         rounding_bytes(wt.shape, gen, wt.device), grouping)
            args = (xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, kb)
            want = mls_matmul_ref(*args)
            plan = matmul_plan(M, N, K, kb, fmt)
            plans = [plan]
            if K // kb > 1:
                plans.append(dataclasses.replace(
                    plan, variant="walk" if plan.variant == "split" else "split"))
            for p in plans:
                got = mls_matmul(*args, grouping, plan=p)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                checks.append(dict(kernel="mls_matmul", shape=sname, fmt=str(fmt),
                                   grouping=grouping, k_block=kb, plan=dataclasses.asdict(p),
                                   chosen=p == plan, identical=torch.equal(got, want),
                                   max_abs_err=err, finite=bool(torch.isfinite(got).all())))
            timed_case = (fmt is FMT_IMAGENET and grouping == "nc") or \
                (fmt.max_fraction > 127 and sname == "stage1_wgrad")
            if not timed_case:
                continue
            xs_shape, ws_shape = sg_shapes(grouping, M, N, K // kb)
            run = lambda p: lambda: mls_matmul(*args, grouping, plan=p)  # noqa: E731
            row = dict(
                ms=cuda_ms(run(plan)), kernel_ms=kernel_ms(run(plan), DEVICE_KERNELS["mls_matmul"]),
                plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=20, warmup=1),
                bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                + 4 * M * N + 8,
                ops=2 * M * N * K, max_abs_err=err, plan=dataclasses.asdict(plan),
                shape=f"{'int32_' if fmt.max_fraction > 127 else ''}{sname} "
                      f"({M}x{K}x{N}) kb{kb} {grouping} {fmt}")
            if len(plans) > 1:
                row.update(other_plan=plans[1].variant, other_ms=cuda_ms(run(plans[1])),
                           other_kernel_ms=kernel_ms(run(plans[1]),
                                                     DEVICE_KERNELS["mls_matmul"]))
            timed[("mls_matmul", sname, str(fmt), grouping)] = row
        del x, wt
    return checks


def implicit_conv_checks(gen, timed: dict) -> list[dict]:
    """K4 against its plain version and the im2col route at CONV_SHAPES,
    four groupings, stochastic rounding bytes: <2,4> and <2,1> at the stage
    convs, <3,1> (the int32 body) at stage 1, <2,4> at the zoo convs (which
    the dispatch must send to K4).  The <2,4> stage-conv cases are timed,
    beside the im2col route of the same conv (pad, unfold, K1 on the
    patches and on the weight, K3), and for "c" and "n" beside the
    PyTorch glue that made their compact scales before this slice
    (``_implicit_x_scales`` on a padded copy)."""
    import torch

    from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat
    from repro_torch.core import QuantConfig
    from repro_torch.kernels import (conv_geometry, implicit_conv_forward, implicit_conv_ref,
                                     mls_matmul, mls_quantize, resolve_conv_impl)
    from repro_torch.kernels.implicit_conv import _implicit_x_scales, _pad
    from repro_torch.kernels.ref import im2col

    def im2col_route(x, w, r_x, r_w, geom, fmt, grouping, kb=K_BLOCK_IMPLICIT):
        cols, _ = im2col(x, (geom.kh, geom.kw), (geom.sh, geom.sw), geom.pads)
        xc, xsg, xst = mls_quantize(cols, fmt, kb, GS_FMT_DEFAULT, r_x, grouping)
        wc, wsgT, wst = mls_quantize(w.reshape(geom.o, -1), fmt, kb, GS_FMT_DEFAULT, r_w,
                                     grouping)
        return mls_matmul(xc, xsg, xst, wc.t(), wsgT.t(), wst, fmt, kb, grouping)

    checks = []
    for sname, (xs, ws, stride, k_block) in CONV_SHAPES.items():
        geom = conv_geometry(xs, ws, stride, "SAME")
        if resolve_conv_impl(geom, QuantConfig(k_block=k_block)) != "implicit":
            raise AssertionError(f"{sname}: the dispatch does not send it to K4")
        x = torch.randn(xs, generator=gen, device="cuda")
        w = torch.randn(ws, generator=gen, device="cuda") * math.sqrt(2.0 / geom.k0)
        r_x = torch.randint(0, 256, (geom.m0, geom.k0), generator=gen, dtype=torch.uint8,
                            device="cuda")
        r_w = torch.randint(0, 256, (geom.o, geom.k0), generator=gen, dtype=torch.uint8,
                            device="cuda")
        # <2,4> and <2,1> on the int8 body; <3,1> (fractions up to 192) on
        # the int32 body at stage 1, k_block 72 (144 would need 24 bits)
        zoo = k_block == K_BLOCK
        cases = [(fmt, k_block) for fmt in ((FMT_IMAGENET,) if zoo else (FMT_IMAGENET, FMT_CIFAR))]
        if sname == "stage1_conv":
            cases.append((EMFormat(*FMT_INT32), 72))
        for fmt, kb in cases:
            for grouping in ("nc", "c", "n", "none"):
                kw = dict(fmt=fmt, gs_fmt=GS_FMT_DEFAULT, k_block=kb, grouping=grouping)
                got = implicit_conv_forward(x, w, r_x, r_w, stride, "SAME", **kw)
                want = implicit_conv_ref(x, w, r_x, r_w, stride, geom.pads, **kw)
                via_im2col = im2col_route(x, w, r_x, r_w, geom, fmt, grouping, kb)
                torch.cuda.synchronize()
                err = max_abs_err(got, want)
                y2d = got.permute(0, 2, 3, 1).reshape(geom.m0, geom.o)
                checks.append(dict(kernel="implicit_conv", shape=sname, fmt=str(fmt),
                                   k_block=kb, grouping=grouping,
                                   identical=torch.equal(got, want), max_abs_err=err,
                                   equals_im2col=torch.equal(y2d, via_im2col),
                                   finite=bool(torch.isfinite(got).all())))
                if fmt is FMT_IMAGENET and not zoo:
                    timed[("implicit_conv", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(lambda: implicit_conv_forward(x, w, r_x, r_w, stride, "SAME",
                                                                 **kw)),
                        plain_ms=cuda_ms(lambda: implicit_conv_ref(x, w, r_x, r_w, stride,
                                                                   geom.pads, **kw)),
                        im2col_ms=cuda_ms(lambda: im2col_route(x, w, r_x, r_w, geom, fmt,
                                                               grouping)),
                        **({"glue_ms": cuda_ms(lambda: _implicit_x_scales(
                            _pad(x, geom), geom, GS_FMT_DEFAULT, kb, grouping))}
                           if grouping in ("c", "n") else {}),
                        kernel_ms=kernel_ms(lambda: implicit_conv_forward(
                            x, w, r_x, r_w, stride, "SAME", **kw),
                            DEVICE_KERNELS["implicit_conv"]),
                        # x, w, both rounding-byte tensors read once, fp32 output written once
                        bytes=4 * x.numel() + 4 * w.numel() + r_x.numel() + r_w.numel()
                        + 4 * geom.m0 * geom.o,
                        ops=2 * geom.m0 * geom.k0 * geom.o, max_abs_err=err,
                        shape=f"{sname} x{xs} w{ws} s{stride[0]} {grouping} {fmt}")
        del x, r_x
    return checks


def zoo_gemms(geom, kb: int) -> dict[str, tuple]:
    """The three GEMMs of a conv's training step as qd_gemm makes them,
    (M, K real, K padded to ``kb``, N): forward cols @ wmat, weight
    gradient cols.T @ e2d, data gradient e2d @ wmat.T."""
    pad = lambda k: -(-k // kb) * kb  # noqa: E731
    return {"fwd": (geom.m0, geom.k0, pad(geom.k0), geom.o),
            "wgrad": (geom.k0, geom.m0, pad(geom.m0), geom.o),
            "dgrad": (geom.m0, geom.o, pad(geom.o), geom.k0)}


def zoo_checks(gen, timed: dict) -> list[dict]:
    """K1 and K3 at the zoo phase's own shapes (ZOO_CONVS, traced at the
    zoo phase's sizes): for each of a conv's three GEMMs, K1 ("nc" and
    "n", <2,4>, stochastic rounding bytes) on both operands against
    quantize_ref, and K3 on those codes against mls_matmul_ref, on the plan
    matmul_plan picks and on the other variant.  The "nc" calls are timed
    (the plain versions on 3 calls: they take up to seconds here)."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_matmul import matmul_plan, sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    checks = []
    for cname, (arch, pick) in ZOO_CONVS.items():
        hw, classes, batch = ZOO[arch]
        geom = next(g for g in conv_list(arch, hw, batch, classes) if pick(g))
        for gname, (M, real, K, N) in zoo_gemms(geom, kb).items():
            sname = f"zoo {cname} {gname}"
            x = quantize_operand(M, real, K, gen)
            wt = quantize_operand(N, real, K, gen)  # the weight side, quantized as (N, K)
            rx = rounding_bytes(x.shape, gen, x.device)
            rw = rounding_bytes(wt.shape, gen, wt.device)
            for grouping in ("nc", "n"):
                qx = mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, rx, grouping)
                qw = mls_quantize(wt, fmt, kb, GS_FMT_DEFAULT, rw, grouping)
                pairs = [(qx, quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, rx, grouping)),
                         (qw, quantize_ref(wt, fmt, kb, GS_FMT_DEFAULT, rw, grouping))]
                torch.cuda.synchronize()
                err = max(max_abs_err(a, b) for got, want in pairs for a, b in zip(got, want))
                checks.append(dict(kernel="mls_quantize_rows", shape=sname, fmt=str(fmt),
                                   grouping=grouping, operands=[(M, K), (N, K)],
                                   identical=all(torch.equal(a, b) for got, want in pairs
                                                 for a, b in zip(got, want)),
                                   max_abs_err=err))
                if grouping == "nc":
                    run = lambda: mls_quantize(x, fmt, kb, GS_FMT_DEFAULT, rx, "nc")  # noqa: E731
                    timed[("mls_quantize_rows", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(run),
                        kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_rows"]),
                        plain_ms=cuda_ms(lambda: quantize_ref(x, fmt, kb, GS_FMT_DEFAULT, rx,
                                                              grouping), iters=3, warmup=1),
                        bytes=M * K * 6 + qx[1].numel() * 4 + 4, ops=0, max_abs_err=err,
                        shape=f"{sname} ({M}, {K}) {grouping} {fmt}")
                args = (*qx, qw[0].t(), qw[1].t(), qw[2], fmt, kb)
                want = mls_matmul_ref(*args)
                plan = matmul_plan(M, N, K, kb, fmt)
                plans = [plan]
                if K // kb > 1:
                    plans.append(dataclasses.replace(
                        plan, variant="walk" if plan.variant == "split" else "split"))
                for p in plans:
                    got = mls_matmul(*args, grouping, plan=p)
                    torch.cuda.synchronize()
                    err = max_abs_err(got, want)
                    checks.append(dict(kernel="mls_matmul", shape=sname, fmt=str(fmt),
                                       grouping=grouping, k_block=kb, mkn=(M, K, N),
                                       plan=dataclasses.asdict(p), chosen=p == plan,
                                       identical=torch.equal(got, want), max_abs_err=err,
                                       finite=bool(torch.isfinite(got).all())))
                    del got
                if grouping == "nc":
                    xs_shape, ws_shape = sg_shapes(grouping, M, N, K // kb)
                    run = lambda: mls_matmul(*args, grouping, plan=plan)  # noqa: E731
                    timed[("mls_matmul", sname, str(fmt), grouping)] = dict(
                        ms=cuda_ms(run), kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_matmul"]),
                        plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                        bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                        + 4 * M * N + 8,
                        ops=2 * M * N * K, max_abs_err=checks[-len(plans)]["max_abs_err"],
                        plan=dataclasses.asdict(plan),
                        shape=f"{sname} ({M}x{K}x{N}) kb{kb} {grouping} {fmt}")
                del qx, qw, want, args, pairs
            del x, wt, rx, rw
            torch.cuda.empty_cache()
    return checks


def nan_checks() -> list[dict]:
    """K1 ("nc", "n") and K4 (four groupings) on an input holding one NaN,
    against their plain versions on the CPU, whose division keeps the NaN's
    payload (the card's would give its canonical NaN): K1's scales equal
    and every code but the NaN's own; K4's every output whose patch does
    not cover the NaN.  Stage-1 shapes at batch 8 (K1: the patches of that
    conv, K padded to 256)."""
    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import conv_geometry, implicit_conv_forward, mls_quantize

    gen = torch.Generator().manual_seed(7)
    checks = []
    x = torch.randn((8 * HW * HW, 256), generator=gen)
    x[7, 40] = float("nan")
    r = torch.randint(0, 256, x.shape, generator=gen, dtype=torch.uint8)
    for grouping in ("nc", "n"):
        want = mls_quantize(x, FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT, r, grouping)
        got = [t.cpu() for t in mls_quantize(x.cuda(), FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT,
                                             r.cuda(), grouping)]
        keep = ~torch.isnan(x)
        same = (torch.equal(got[0][keep], want[0][keep]) and torch.equal(got[1], want[1])
                and float(got[2]) == float(want[2]) == 1.0)
        checks.append(dict(kernel="mls_quantize_rows", shape=f"nan {tuple(x.shape)}",
                           fmt=str(FMT_IMAGENET), grouping=grouping, identical=same,
                           max_abs_err=0.0 if same else float("nan")))
    xs, ws = (8, 16, HW, HW), (16, 16, 3, 3)
    geom = conv_geometry(xs, ws, (1, 1), "SAME")
    xc = torch.randn(xs, generator=gen)
    xc[1, 2, 3, 5] = float("nan")
    w = torch.randn(ws, generator=gen) * 0.1
    r_x = torch.randint(0, 256, (geom.m0, geom.k0), generator=gen, dtype=torch.uint8)
    r_w = torch.randint(0, 256, (geom.o, geom.k0), generator=gen, dtype=torch.uint8)
    hit = torch.zeros((8, HW, HW), dtype=torch.bool)
    hit[1, 2:5, 4:7] = True  # the outputs whose 3x3 patch covers (3, 5)
    for grouping in ("nc", "c", "n", "none"):
        kw = dict(fmt=FMT_IMAGENET, k_block=K_BLOCK_IMPLICIT, grouping=grouping)
        want = implicit_conv_forward(xc, w, r_x, r_w, (1, 1), "SAME", **kw)
        got = implicit_conv_forward(xc.cuda(), w.cuda(), r_x.cuda(), r_w.cuda(), (1, 1),
                                    "SAME", **kw).cpu()
        keep = ~hit[:, None].expand_as(got)
        same = torch.equal(got[keep], want[keep])
        checks.append(dict(kernel="implicit_conv", shape=f"nan stage1 x{xs}",
                           fmt=str(FMT_IMAGENET), grouping=grouping, identical=same,
                           max_abs_err=max_abs_err(got[keep], want[keep])))
    return checks


def conv_list(arch: str, hw: int, batch: int, num_classes: int = 10) -> list:
    """The geometry of a model's quantized convs at full width, traced by
    ``models.nn.OpTrace`` on the meta device."""
    from repro_torch.models.cnn import CNNConfig, quantized_convs

    return quantized_convs(CNNConfig(arch, num_classes, 1.0, hw), batch)


def expected_launches(qcfg, convs) -> dict[str, int]:
    """Kernel launches of one training step, from the dispatch of each conv
    (``convs``: the geometries of ``conv_list``): forward implicit (K4 +
    the weight's quantizer) or im2col (2 quantizes + K3); weight gradient
    with code reuse (grouping "none", nearest, implicit: K4's tensor-scale
    pass, a given-scale code pass, the error's quantizer, K3) or without
    (2 quantizes + K3); data gradient (2 quantizes + K3).  K2 counts its
    two entry points under one name."""
    from repro_torch.kernels import launch_counts, resolve_conv_impl

    q = "mls_quantize_rows" if qcfg.grouping in ("nc", "n") else "mls_quantize_given_sg"
    n = collections.Counter()
    for geom in convs:
        impl = resolve_conv_impl(geom, qcfg)
        if impl == "implicit":
            n.update({"implicit_conv": 1, q: 1})
        else:
            n.update({q: 2, "mls_matmul": 1})
        if qcfg.grouping == "none" and not qcfg.stochastic and impl == "implicit":
            n.update({"conv_tensor_scale": 1, "mls_quantize_given_sg": 2, "mls_matmul": 1})
        else:
            n.update({q: 2, "mls_matmul": 1})
        n.update({q: 2, "mls_matmul": 1})
    return {k: n[k] for k in launch_counts()}


def run_path(results: dict, key: str, qcfg, steps: int) -> dict[str, int]:
    """Train ``steps`` full-width steps with ``qcfg``, counts set to 0 just
    before and read just after; every step must launch what the dispatch
    says and give a finite loss.  Returns the path's launches."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.train.loop import train_variant

    want = expected_launches(qcfg, conv_list("resnet20", HW, BATCH))
    reset_launch_counts()
    res = train_variant(key, qcfg, steps, width=1.0, hw=HW, batch=BATCH, device="cuda")
    counts = launch_counts()
    step_ms = statistics.median(res.step_s[1:]) * 1e3 if steps > 1 else None
    results[key] = dict(losses=res.losses, accs=res.accs, step_s=res.step_s,
                        median_step_ms=step_ms, launches_per_step=res.launches,
                        expected_per_step=want, launches=counts)
    print(f"{key}: losses {res.losses} median step after step 1 {step_ms} ms "
          f"launches {counts}, expected per step {want}")
    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{key}: non-finite loss: {res.losses}")
    for i, per in enumerate(res.launches):
        if per != want:
            raise AssertionError(f"{key} step {i}: launches {per}, expected {want}")
    return counts


def phase_train(results: dict) -> dict[str, int]:
    """The main path, the given-scale path, the implicit path and its
    grouping-"none" pass; returns each kernel's launches on its path."""
    from repro_torch.core import FMT_IMAGENET, QuantConfig

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    main = run_path(results, "train", qcfg, TRAIN_STEPS)
    if expected_launches(qcfg, conv_list("resnet20", HW, BATCH)) != {
            "mls_quantize_rows": 120, "mls_quantize_given_sg": 0, "mls_matmul": 60,
            "implicit_conv": 0, "conv_tensor_scale": 0, "sabotage_overlap": 0}:
        raise AssertionError("the k_block-128 path no longer takes 120 quantize and 60 GEMM "
                             "launches per step on im2col alone")
    # paper Table IV grouping "c": the given-scale quantize kernel's path
    qc = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="c", stochastic=True)
    c_counts = run_path(results, "train_grouping_c", qc, 2)
    # the implicit path: K4 on the 18 3x3 convs
    qi = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK_IMPLICIT, grouping="nc", stochastic=True)
    i_counts = run_path(results, "train_implicit", qi, TRAIN_STEPS)
    qn = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK_IMPLICIT, grouping="none",
                     stochastic=False)
    run_path(results, "train_implicit_none", qn, 2)
    return {**main, "mls_quantize_given_sg": c_counts["mls_quantize_given_sg"],
            "implicit_conv": i_counts["implicit_conv"]}


def phase_trace(results: dict) -> None:
    """Where a step's time goes, on the main path, the implicit path and
    the grouping-"c" path (K2's): 3 more steps of each under
    torch.profiler; device time by kernel, the port's kernels against the
    rest, and the device's idle share of the host-clock step time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.train.loop import train_variant

    from repro_torch.kernels import launch_counts, reset_launch_counts

    ours = tuple(n for names in DEVICE_KERNELS.values() for n in names)
    steps = 3
    for key, k_block, grouping in (("trace", K_BLOCK, "nc"),
                                   ("trace_implicit", K_BLOCK_IMPLICIT, "nc"),
                                   ("trace_grouping_c", K_BLOCK, "c")):
        qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=k_block, grouping=grouping,
                           stochastic=True)
        reset_launch_counts()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res = train_variant("traced", qcfg, steps, width=1.0, hw=HW, batch=BATCH,
                                device="cuda", log=lambda *_: None)
            torch.cuda.synchronize()
        by_name: dict[str, float] = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
        ours_ms = sum(v for k, v in by_name.items() if any(o in k for o in ours))
        launched = launch_counts()  # K1 and K2 share quantize_amax: only the path's own
        by_entry = {entry: sum(v for k, v in by_name.items() if any(o in k for o in names))
                    / steps for entry, names in DEVICE_KERNELS.items() if launched[entry]}
        device_ms = sum(by_name.values())
        host_ms = sum(res.step_s) * 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        trace = dict(k_block=k_block, grouping=grouping, steps=steps,
                     host_ms_per_step=host_ms / steps,
                     device_ms_per_step=device_ms / steps,
                     port_kernels_ms_per_step=ours_ms / steps,
                     kernels_ms_per_step_by_entry=by_entry,
                     other_device_ms_per_step=(device_ms - ours_ms) / steps,
                     device_idle_share=1.0 - device_ms / host_ms if host_ms else None,
                     top_kernels_ms_per_step=[(k[:90], v / steps) for k, v in top])
        results[key] = trace
        print(json.dumps({key: trace}))
        if device_ms <= 0:
            raise AssertionError("the profiler recorded no device time")


def card_vs_cpu(qcfg) -> dict:
    """One small ResNet-20 train step (width 1/4, 8x8, batch 4) on the card
    and on the CPU (the plain versions): the loss, logits and gradients
    compared, and the card's launches."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.cnn import CNNConfig, init_cnn

    cfg = CNNConfig("resnet20", width_mult=0.25, in_hw=8)
    gen = torch.Generator().manual_seed(1)
    x, y = torch.randn((4, 3, 8, 8), generator=gen), torch.randint(0, 10, (4,), generator=gen)
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_cnn(cfg, seed=3, device=dev)
        reset_launch_counts()
        logits = model(x.to(dev), qcfg)
        loss = F.cross_entropy(logits, y.to(dev))
        loss.backward()
        out[dev] = (float(loss.detach()), logits.detach().cpu(),
                    {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                    launch_counts())
    (l_cpu, z_cpu, g_cpu, _), (l_gpu, z_gpu, g_gpu, counts) = out["cpu"], out["cuda"]
    cos, grad_rel = 1.0, 0.0
    for n in g_cpu:
        a, b = g_gpu[n].flatten().double(), g_cpu[n].flatten().double()
        cos = min(cos, float(a @ b / (a.norm() * b.norm())))
        grad_rel = max(grad_rel, float((a - b).norm() / b.norm()))
    rel = abs(l_gpu - l_cpu) / abs(l_cpu)
    z_err = max_abs_err(z_cpu, z_gpu)
    # tolerance: the quantized convs are bit-exact, but the stem conv, BN
    # and the classifier reduce in another order on the card (on the
    # fake-quant backend every conv is an fp32 conv of the quantized
    # operands), so the last bits differ (seen: loss equal, logits within
    # 7.2e-7, fp32 gradient cosine above 1 - 1.2e-7); each limit is far
    # below what a wrong kernel or a flipped code gives
    ok = (rel <= 1e-5 and z_err <= 1e-5 and cos >= 1 - 1e-5 and grad_rel <= 1e-4
          and bool(torch.isfinite(z_gpu).all()))
    return dict(k_block=qcfg.k_block, backend=qcfg.backend, loss_cpu=l_cpu, loss_gpu=l_gpu,
                loss_rel=rel, min_grad_cos=cos, max_grad_rel=grad_rel, logits_max_abs=z_err,
                card_launches=counts, agree=ok)


def phase_agree(results: dict) -> None:
    """One small train step on the card agrees with the CPU's plain run, on
    im2col (k_block 32) and with every 3x3 conv implicit (k_block 36)."""
    from repro_torch.core import FMT_IMAGENET, QuantConfig

    disagree = []
    for k_block in (32, 36):
        key = "agree" if k_block == 32 else "agree_implicit"
        results[key] = r = card_vs_cpu(QuantConfig(fmt=FMT_IMAGENET, k_block=k_block,
                                                   stochastic=False))
        print(f"{key}: {r}")
        if not r["agree"]:
            disagree.append(key)
        if (r["card_launches"]["implicit_conv"] > 0) != (k_block == 36):
            disagree.append(f"{key}: launches {r['card_launches']}")
    if disagree:
        raise AssertionError(f"card and CPU disagree: {disagree}")


def traced_step(state, qcfg, lr: float) -> dict:
    """One more train step under torch.profiler: device busy (the sum of
    kernel times), the port's kernels' share, and the device's idle share
    of the host-clock step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.train.loop import train_step

    ours = tuple(n for names in DEVICE_KERNELS.values() for n in names)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_step(state, qcfg, lr)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return dict(host_ms_under_profiler=host_ms, device_ms=device_ms,
                port_kernels_ms=sum(v for k, v in by_name.items() if any(o in k for o in ours)),
                device_idle_share=1.0 - device_ms / host_ms,
                top_kernels_ms=[(k[:80], v) for k, v in top])


ZOO_STEPS = 2


def phase_zoo(results: dict) -> None:
    """VGG-16, GoogleNet, ResNet-18 and ResNet-34 at full width on the
    quantized backend (<2,4>, k_block 128, "nc", stochastic rounding):
    ZOO_STEPS steps each with counts set to 0 just before and read just
    after; finite losses, and every step's launches equal to the dispatch's
    count over the model's traced quantized convs (K1 and K3 on every
    model, K4 where the dispatch picks it).  Step times (host clock, after
    a device sync), the peak device memory, and one more step traced."""
    import torch

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train.loop import init_state, train_step

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK, grouping="nc", stochastic=True)
    bad = []
    for arch, (hw, classes, batch) in ZOO.items():
        want = expected_launches(qcfg, conv_list(arch, hw, batch, classes))
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(CNNConfig(arch, classes, 1.0, hw), batch, seed=0, device="cuda")
        losses, step_ms, per_step = [], [], []
        reset_launch_counts()
        for _ in range(ZOO_STEPS):
            before = launch_counts()
            t0 = time.perf_counter()
            loss, _ = train_step(state, qcfg, 0.05)
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
            per_step.append({k: v - before[k] for k, v in launch_counts().items()})
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        trace = traced_step(state, qcfg, 0.05)
        r = dict(hw=hw, classes=classes, batch=batch, losses=losses, step_ms=step_ms,
                 launches_per_step=per_step, expected_per_step=want, launches=counts,
                 peak_memory_bytes=peak, trace=trace)
        results[f"zoo_{arch}"] = r
        print(f"zoo {arch}: {hw}x{hw} batch {batch}: losses {losses} step ms {step_ms} "
              f"peak memory {peak / 2**30:.2f} GiB launches/step {per_step[0]} "
              f"device busy {trace['device_ms']:.1f} ms of {trace['host_ms_under_profiler']:.1f}"
              f" (profiled)")
        if not all(math.isfinite(v) for v in losses):
            bad.append(f"{arch}: non-finite loss {losses}")
        if any(p != want for p in per_step):
            bad.append(f"{arch}: launches {per_step}, expected {want}")
        if not (counts["mls_quantize_rows"] and counts["mls_matmul"]):
            bad.append(f"{arch}: K1 or K3 not launched: {counts}")
        del state
    if bad:
        raise AssertionError("; ".join(bad))


FAKE_QUANT_STEPS = 5


def phase_fakequant(results: dict) -> None:
    """The fake-quant backend (the JAX package's default; the quantizer is
    PyTorch code and the convs are fp32 convs, as the JAX package runs them
    outside any Pallas kernel, so no kernel of the port launches): full-width
    ResNet-20, batch 128, <2,1>, stochastic rounding, FAKE_QUANT_STEPS
    steps with finite losses; one more step traced; and a small step on
    the card that agrees with the CPU."""
    import torch

    from repro_torch.core import FMT_CIFAR, QuantConfig
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train.loop import init_state, train_step

    qcfg = QuantConfig(fmt=FMT_CIFAR, k_block=K_BLOCK, backend="fake_quant")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = init_state(CNNConfig("resnet20", 10, 1.0, HW), BATCH, seed=0, device="cuda")
    reset_launch_counts()
    losses, step_ms = [], []
    for _ in range(FAKE_QUANT_STEPS):
        t0 = time.perf_counter()
        losses.append(train_step(state, qcfg, 0.05)[0])
        step_ms.append((time.perf_counter() - t0) * 1e3)
    counts = launch_counts()
    r = dict(losses=losses, step_ms=step_ms, median_step_ms=statistics.median(step_ms[1:]),
             peak_memory_bytes=torch.cuda.max_memory_allocated(), launches=counts,
             trace=traced_step(state, qcfg, 0.05),
             agree=card_vs_cpu(QuantConfig(fmt=FMT_CIFAR, k_block=32, stochastic=False,
                                           backend="fake_quant")))
    results["fake_quant"] = r
    print(f"fake_quant: losses {losses} median step {r['median_step_ms']:.2f} ms peak "
          f"{r['peak_memory_bytes'] / 2**30:.2f} GiB device busy {r['trace']['device_ms']:.1f} ms"
          f"; agree {r['agree']}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"fake_quant: non-finite loss {losses}")
    if any(counts.values()):
        raise AssertionError(f"fake_quant launched the port's kernels: {counts}")
    if not r["agree"]["agree"]:
        raise AssertionError(f"fake_quant: card and CPU disagree: {r['agree']}")


def phase_driver(results: dict) -> None:
    """The CIFAR driver (examples/torch_train_cifar_lowbit.py) for a few
    full-width steps on the quantized backend; a checkpoint of the main
    path's state saved on the card and restored on the card and on the CPU
    (every tensor equal to the saved one); and the run resumed from it,
    whose next loss equals the uninterrupted run's."""
    import importlib.util
    import tempfile

    import torch

    from repro_torch.core import FMT_IMAGENET, QuantConfig
    from repro_torch.models.cnn import CNNConfig
    from repro_torch.train import CheckpointManager
    from repro_torch.train.loop import init_state, train_step

    spec = importlib.util.spec_from_file_location(
        "torch_train_cifar_lowbit", ROOT / "examples" / "torch_train_cifar_lowbit.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    runs = example.main(["--steps", "3", "--width", "1.0", "--hw", str(HW), "--batch",
                         str(BATCH), "--backend", "quantized", "--device", "cuda"])
    bad = [f"driver {n}: non-finite loss {r.losses}" for n, r in runs.items()
           if not all(math.isfinite(v) for v in r.losses)]

    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=K_BLOCK)
    cfg = CNNConfig("resnet20", 10, 1.0, HW)
    run = init_state(cfg, BATCH, seed=0, device="cuda")
    for _ in range(2):
        train_step(run, qcfg, 0.05)
    saved = run.state_dict()
    saved_copy = [t.detach().clone() for t in _tensors(saved)]  # the state dict is live
    same = True
    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2)
        mgr.save(run.step, saved, blocking=False)
        next_loss = train_step(run, qcfg, 0.05)[0]  # the uninterrupted run steps on
        mgr.wait()
        for device in ("cuda", "cpu"):
            restored = mgr.restore(init_state(cfg, BATCH, seed=0, device="cuda").state_dict(),
                                   device=device)
            for a, b in zip(saved_copy, _tensors(restored)):
                same &= b.device.type == device and torch.equal(a.cpu(), b.cpu())
        resumed = init_state(cfg, BATCH, seed=0, device="cuda")
        resumed.load_state_dict(mgr.restore(resumed.state_dict(), device="cuda"))
        resumed_loss = train_step(resumed, qcfg, 0.05)[0]
    results["driver"] = dict(example_losses={n: r.losses for n, r in runs.items()},
                             straggler={n: r.straggler for n, r in runs.items()},
                             restored_equal=same, next_loss=next_loss,
                             resumed_loss=resumed_loss)
    print(f"driver: {results['driver']}")
    if not same:
        bad.append("a restored tensor differs from the saved one")
    if resumed_loss != next_loss:
        bad.append(f"resumed loss {resumed_loss} != uninterrupted {next_loss}")
    if bad:
        raise AssertionError("; ".join(bad))


# The serve phase: the LM serving path (repro_torch.serve.ServeEngine) on
# the quantized kernels, random weights from seed 0, bf16 compute as the
# FULL configs say.  name: (config overrides, prompt length); every model
# serves SERVE_BATCH prompts and SERVE_NEW new tokens (one prefill, then
# SERVE_NEW - 1 decode steps).  mamba2-370m's prompt of 320 is not a
# multiple of its ssm_chunk 256: the chunk is 160 by the divisor rule.
# zamba2-7b's depth is cut from 81 to 12 layers (the shared block runs
# twice) and its window set to 136, under 128 + 15, so that the ring
# buffer wraps during decode.  The MoE configs are cut in depth to what one
# card holds in fp32 beside the experts' fake-quant temporaries:
# moonshot-v1-16b-a3b to 16 of 48 layers (0.571 G parameters, 2.28 GB, per
# layer; the embedding and head 2.68 GB: 39.2 GB), llama4-scout-17b-a16e to
# 4 of 48 (8.81 GB per layer, embedding and head 8.28 GB: 43.5 GB).
# seamless-m4t-medium runs whole, its encoder over SERVE_SRC_LEN frames of
# random frontend embeddings per prompt.
SERVE_BATCH, SERVE_NEW, SERVE_SRC_LEN = 4, 16, 1024
SERVE_MODELS = {
    "chatglm3-6b": ({}, 128),
    "mamba2-370m": ({}, 320),
    "zamba2-7b": ({"n_layers": 12, "window": 136}, 128),
    "moonshot-v1-16b-a3b": ({"n_layers": 16}, 128),
    "llama4-scout-17b-a16e": ({"n_layers": 4}, 128),
    "seamless-m4t-medium": ({}, 128),
}
SERVE_CUTS = {
    "zamba2-7b": "n_layers 81 -> 12 (2 shared-block applications), window 136",
    "moonshot-v1-16b-a3b": "n_layers 48 -> 16 (all 48 are 112 GB of fp32 weights)",
    "llama4-scout-17b-a16e": "n_layers 48 -> 4 (8.8 GB of fp32 weights per layer)",
}


def lm_inputs(cfg, tokens, gen, src_len: int) -> dict:
    """The batch of ``tokens`` as a user passes it: the encoder-decoder's
    also holds ``src_len`` frames of random frontend embeddings from
    ``gen`` for its encoder (``src_emb`` (B, src_len, frontend_dim))."""
    import torch

    batch = {"tokens": tokens}
    if cfg.family == "encdec":
        batch["src_emb"] = torch.randn((tokens.shape[0], src_len, cfg.frontend_dim),
                                       generator=gen, device=tokens.device)
    return batch


CONFIG_KEYS = ("n_layers", "enc_layers", "d_model", "n_heads", "n_kv_heads", "d_ff", "moe_d_ff",
               "n_experts", "top_k", "n_shared_experts", "vocab", "compute_dtype", "window",
               "remat")


def serve_linears(cfg, prefill: bool = False) -> int:
    """Quantized linears per serving step (decode, or with ``prefill`` the
    prefill); each launches K1 twice and K3 once.  An attention block has 4
    (wq, wk, wv, wo) and its MLP 3 (w_up, w_gate, w_down; 2 ungated); an
    MoE layer its attention and its shared expert's MLP (the routed experts
    run fake-quant GEMMs, no kernel); a Mamba2 layer 2 (in_proj, out_proj);
    an encoder-decoder's decoder layer its self-attention, the cross
    attention's wq and wo (its K/V are computed once at prefill,
    unquantized) and its MLP, and the prefill also runs the encoder."""
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.family == "dense":
        return (4 + mlp) * cfg.n_layers
    if cfg.family == "moe":
        return (4 + (mlp if cfg.n_shared_experts else 0)) * cfg.n_layers
    if cfg.family == "encdec":
        return (6 + mlp) * cfg.n_layers + ((4 + mlp) * cfg.enc_layers if prefill else 0)
    if cfg.family == "ssm":
        return 2 * cfg.n_layers
    return 2 * cfg.n_layers + (4 + mlp) * (cfg.n_layers // cfg.attn_every)


def lm_train_launches(cfg, microbatch: int = 1) -> dict[str, int]:
    """K1 and K3 launches of one LM training step (lm_loss forward and
    backward): each quantized linear runs qd_gemm for its forward, its data
    gradient and its weight gradient (K1 on both operands, then K3), and
    under full remat once more for the recomputed forward; the hybrid's
    shared block is not remat'd.  In training the encoder-decoder's cross
    attention computes its K/V from the encoder's output, quantized, so a
    decoder layer has 8 attention linears.  Times the microbatches."""
    per = 4 if cfg.remat == "full" else 3
    mlp = 3 if cfg.gated_mlp else 2
    if cfg.family == "dense":
        k3 = (4 + mlp) * cfg.n_layers * per
    elif cfg.family == "moe":
        k3 = (4 + (mlp if cfg.n_shared_experts else 0)) * cfg.n_layers * per
    elif cfg.family == "encdec":
        k3 = ((4 + mlp) * cfg.enc_layers + (8 + mlp) * cfg.n_layers) * per
    else:
        k3 = 2 * cfg.n_layers * per  # in_proj, out_proj
        if cfg.family == "hybrid":
            k3 += (4 + mlp) * (cfg.n_layers // cfg.attn_every) * 3
    return {"mls_quantize_rows": 2 * k3 * microbatch, "mls_matmul": k3 * microbatch}


def traced_decode(engine, cache, tok) -> dict:
    """One decode step under torch.profiler: device busy (the sum of kernel
    times), K1's and K3's kernel time, the MoE experts' fake-quant
    (_experts_ms), and the device's idle share of the host-clock step."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU,
                                                      ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        logits, _ = engine.decode(cache, tok)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    of = lambda entry: sum(v for k, v in by_name.items()  # noqa: E731
                           if any(n in k for n in DEVICE_KERNELS[entry]))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return dict(host_ms_under_profiler=host_ms, device_ms=device_ms,
                k1_ms=of("mls_quantize_rows"), k3_ms=of("mls_matmul"),
                experts_ms=_experts_ms(prof), device_idle_share=1.0 - device_ms / host_ms,
                top_kernels_ms=[(k[:80], v) for k, v in top],
                finite=bool(torch.isfinite(logits).all()))


def serve_model(name: str, smi: str) -> dict:
    """Serve one of SERVE_MODELS at full width through ServeEngine: the
    launches of a whole ``generate`` (counts set to 0 just before, read just
    after), then a prefill and SERVE_NEW - 1 decode steps timed one by one
    (host clock after a device sync) with each step's launches, and one
    decode step traced.  The encoder-decoder's prompts carry SERVE_SRC_LEN
    frames each for its encoder."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import ServeEngine

    over, prompt_len = SERVE_MODELS[name]
    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    engine = ServeEngine(cfg, init_lm(cfg, seed=0, device="cuda"),
                         max_len=prompt_len + SERVE_NEW, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = lm_inputs(cfg, torch.randint(0, cfg.vocab, (SERVE_BATCH, prompt_len),
                                           generator=gen, device="cuda"), gen, SERVE_SRC_LEN)
    n, n_pre = serve_linears(cfg), serve_linears(cfg, prefill=True)
    want = {"mls_quantize_rows": 2 * n, "mls_matmul": n}
    want_pre = {"mls_quantize_rows": 2 * n_pre, "mls_matmul": n_pre}
    want_run = {k: want_pre[k] + (SERVE_NEW - 1) * v for k, v in want.items()}

    reset_launch_counts()
    tokens = engine.generate(prompts, SERVE_NEW)
    torch.cuda.synchronize()
    launched = launch_counts()
    bad = []
    if tuple(tokens.shape) != (SERVE_BATCH, SERVE_NEW) or not bool(
            ((tokens >= 0) & (tokens < cfg.vocab)).all()):
        bad.append(f"generate gave {tuple(tokens.shape)} tokens out of range")
    if {k: launched[k] for k in want} != want_run:
        bad.append(f"generate launched {launched}, expected {want_run}")

    steps_ms, per_step, finite = [], [], True
    with torch.inference_mode():
        for i in range(SERVE_NEW):
            before = launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if i == 0:
                logits, cache = engine.prefill(prompts)
            else:
                logits, cache = engine.decode(cache, tok)
            tok = torch.argmax(logits, dim=-1)[:, None]
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t0) * 1e3)
            per_step.append({k: launch_counts()[k] - before[k] for k in want})
            finite &= bool(torch.isfinite(logits).all())
        same_tokens = torch.equal(tokens[:, -1:], tok)
    trace = traced_decode(engine, cache, tok)
    peak = torch.cuda.max_memory_allocated()
    decode_ms = statistics.median(steps_ms[1:])
    r = dict(config={k: getattr(cfg, k) for k in CONFIG_KEYS},
             cut=SERVE_CUTS.get(name), params=sum(p.numel() for p in engine.model.parameters()),
             batch=SERVE_BATCH, prompt_len=prompt_len, new_tokens=SERVE_NEW,
             src_len=SERVE_SRC_LEN if cfg.family == "encdec" else None,
             prefill_ms=steps_ms[0], decode_ms=steps_ms[1:], decode_ms_median=decode_ms,
             tokens_per_s=SERVE_BATCH * 1e3 / decode_ms, launches_generate=launched,
             launches_per_step=per_step, expected_per_step=[want_pre] + [want] * (SERVE_NEW - 1),
             trace=trace,
             peak_memory_bytes=peak, finite=finite and trace["finite"],
             generate_equals_stepwise=same_tokens, nvidia_smi=smi)
    print(f"serve {name} ({smi}): {r['params'] / 1e9:.3f} G params, prefill "
          f"{r['prefill_ms']:.2f} ms, decode {decode_ms:.2f} ms/step median "
          f"({r['tokens_per_s']:.1f} tokens/s), device busy {trace['device_ms']:.2f} ms of "
          f"{trace['host_ms_under_profiler']:.2f} (idle {trace['device_idle_share']:.3f}), K1 "
          f"{trace['k1_ms']:.2f} ms, K3 {trace['k3_ms']:.2f} ms, experts' fake-quant "
          f"{trace['experts_ms']:.2f} ms per decode step, peak {peak / 2**30:.2f} GiB, launches "
          f"per prefill {per_step[0]}, per decode step {per_step[-1]}"
          + (f"; cut: {r['cut']}" if r["cut"] else ""))
    if not r["finite"]:
        bad.append("a non-finite logit")
    if per_step != r["expected_per_step"]:
        bad.append(f"launches per step {per_step}, expected {r['expected_per_step']}")
    if (cfg.family == "moe") != (trace["experts_ms"] > 0):
        bad.append(f"the experts' fake-quant read {trace['experts_ms']} device ms")
    if not same_tokens:
        bad.append("generate's last tokens differ from the stepwise run's")
    del engine, cache, logits
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    return r


# K1 and K3 at the serving path's GEMMs, (M, K, N): the linear's input x
# (M, K), its weight quantized transposed (N, K), and the GEMM
SERVE_GEMMS = {
    "chatglm3 decode wq/wo": (4, 4096, 4096),
    "chatglm3 decode wk/wv": (4, 4096, 256),
    "chatglm3 decode qkv 4608": (4, 4096, 4608),
    "chatglm3 decode w_up/w_gate": (4, 4096, 13696),
    "chatglm3 decode w_down": (4, 13696, 4096),
    "chatglm3 prefill w_up": (512, 4096, 13696),
    "mamba2 prefill in_proj": (512, 1024, 4384),
    "mamba2 decode in_proj": (4, 1024, 4384),
    "mamba2 decode out_proj": (4, 2048, 1024),
    "zamba2 decode in_proj": (4, 3584, 14576),
    "zamba2 decode out_proj": (4, 7168, 3584),
}
# the models whose serving GEMMs serve_gemms reads from their configs
SERVE_GEMM_MODELS = ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e", "seamless-m4t-medium")


def serve_gemms() -> dict[str, tuple]:
    """{label: (M, K, N, timed)}: SERVE_GEMMS (all timed), then the distinct
    (M, K, N) of every quantized linear of the SERVE_GEMM_MODELS configs (as
    cut) at decode (M = SERVE_BATCH; timed) and at prefill (M = SERVE_BATCH
    x the prompt, or x SERVE_SRC_LEN in an encoder), read from the model
    built on the meta device.  Not quantized, so not here: the LM head,
    the frontend projection, the MoE router and experts (fake-quant GEMMs)
    and the encoder-decoder's cross K/V, which prefill computes in fp32."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import nn as L
    from repro_torch.models.lm import LM

    out = {k: (*v, True) for k, v in SERVE_GEMMS.items()}
    for name in SERVE_GEMM_MODELS:
        over, prompt_len = SERVE_MODELS[name]
        cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
        with torch.device("meta"):
            model = LM(cfg)
        seen = set()
        for mname, mod in model.named_modules():
            if (not isinstance(mod, L.Linear) or mname == "frontend_proj"
                    or mname.endswith(("router", "xattn.wk", "xattn.wv"))):
                continue
            k, n = mod.w.shape
            enc = mname.startswith("enc_layers.")
            steps = [("prefill", SERVE_BATCH * (SERVE_SRC_LEN if enc else prompt_len))]
            if not enc:
                steps.insert(0, ("decode", SERVE_BATCH))
            for step, m in steps:
                if (m, k, n) not in seen:
                    seen.add((m, k, n))
                    where = "encoder " if enc else ""
                    label = f"{name.split('-')[0]} {step} {where}{'.'.join(mname.split('.')[-2:])}"
                    out[label] = (m, k, n, step == "decode")
    return out


def serve_kernel_checks(timed: dict) -> list[dict]:
    """K1 ("nc", <2,4>, nearest rounding: the serving path's) on both
    operands of each serve_gemms GEMM against quantize_ref, and K3 on those
    codes against mls_matmul_ref on the plan matmul_plan picks and on the
    other variant; the rows serve_gemms marks timed (the plain versions on
    3 calls)."""
    import dataclasses

    import torch

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize, rounding_bytes
    from repro_torch.kernels.mls_matmul import matmul_plan, sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(7)
    checks = []
    for sname, (M, K, N, timing) in serve_gemms().items():
        x = torch.randn((M, K), generator=gen, device="cuda")
        wt = torch.randn((N, K), generator=gen, device="cuda") * 0.02
        operands = {"x": x, "w^T": wt}
        coded = {}
        for oname, t in operands.items():
            r = rounding_bytes(t.shape, None, t.device)
            got = mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            want = quantize_ref(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            checks.append(dict(kernel="mls_quantize_rows", shape=f"serve {sname} {oname}",
                               operand=tuple(t.shape), identical=all(
                                   torch.equal(a, b) for a, b in zip(got, want)),
                               max_abs_err=err))
            run = lambda t=t, r=r: mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")  # noqa: E731
            if timing:
                timed[("mls_quantize_rows", sname, oname)] = dict(
                    ms=cuda_ms(run),
                    kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_rows"]),
                    plain_ms=cuda_ms(lambda t=t, r=r: quantize_ref(t, fmt, kb, GS_FMT_DEFAULT,
                                                                   r, "nc"), iters=3, warmup=1),
                    # x read, codes and scales written: nearest rounding needs
                    # no rounding byte, though the wrapper reads a constant one
                    bytes=t.numel() * 5 + got[1].numel() * 4 + 4, ops=0, max_abs_err=err,
                    shape=f"serve {sname} {oname} {tuple(t.shape)}")
            coded[oname] = got
        (xc, xsg, xst), (wc, wsg, wst) = coded["x"], coded["w^T"]
        args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        want = mls_matmul_ref(*args)
        plan = matmul_plan(M, N, K, kb, fmt)
        plans = [plan, dataclasses.replace(plan, variant="walk" if plan.variant == "split"
                                           else "split")]
        for p in plans:
            got = mls_matmul(*args, "nc", plan=p)
            torch.cuda.synchronize()
            checks.append(dict(kernel="mls_matmul", shape=f"serve {sname}", mkn=(M, K, N),
                               plan=dataclasses.asdict(p), chosen=p == plan,
                               identical=torch.equal(got, want),
                               max_abs_err=max_abs_err(got, want),
                               finite=bool(torch.isfinite(got).all())))
        xs_shape, ws_shape = sg_shapes("nc", M, N, K // kb)
        run = lambda p: lambda: mls_matmul(*args, "nc", plan=p)  # noqa: E731
        if timing:
            timed[("mls_matmul", sname)] = dict(
                ms=cuda_ms(run(plan)),
                kernel_ms=kernel_ms(run(plan), DEVICE_KERNELS["mls_matmul"]),
                other_plan=plans[1].variant, other_ms=cuda_ms(run(plans[1])),
                other_kernel_ms=kernel_ms(run(plans[1]), DEVICE_KERNELS["mls_matmul"]),
                plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                bytes=M * K + K * N + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                + 4 * M * N + 8, ops=2 * M * N * K, max_abs_err=checks[-2]["max_abs_err"],
                plan=dataclasses.asdict(plan),
                shape=f"serve {sname} ({M}x{K}x{N}) {plan.variant}")
        del x, wt, coded, args, want, got
        torch.cuda.empty_cache()
    return checks


def weight_requant_ms() -> dict:
    """What re-coding chatglm3-6b's weights costs per serving step, as
    qd_gemm does it on every call: for each of one layer's 7 weights (K, N)
    its transposed fp32 copy (``F.pad(w.float().t(), (0, pk)).contiguous()``,
    pk = 0 here), the nearest-rounding byte fill and K1 on the (N, K) copy,
    each timed by CUDA events; per layer and times the 28 layers."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_quantize, rounding_bytes

    cfg = dataclasses.replace(get_config("chatglm3-6b"), quant_backend="pallas")
    d, kv, f = cfg.d_model, cfg.n_kv_heads * cfg.hd, cfg.d_ff
    shapes = [(d, cfg.n_heads * cfg.hd), (d, kv), (d, kv), (cfg.n_heads * cfg.hd, d), (d, f),
              (d, f), (f, d)]
    gen = torch.Generator(device="cuda").manual_seed(8)
    layer = dict(copy_ms=0.0, fill_ms=0.0, k1_ms=0.0, elements=0)
    for K, N in shapes:
        w = torch.randn((K, N), generator=gen, device="cuda") * 0.02
        wt = F.pad(w.float().t(), (0, (-K) % K_BLOCK)).contiguous()
        r = rounding_bytes(wt.shape, None, wt.device)
        layer["copy_ms"] += cuda_ms(lambda: F.pad(w.float().t(), (0, (-K) % K_BLOCK)).contiguous())
        layer["fill_ms"] += cuda_ms(lambda: rounding_bytes(wt.shape, None, wt.device))
        layer["k1_ms"] += cuda_ms(lambda: mls_quantize(wt, FMT_IMAGENET, K_BLOCK, GS_FMT_DEFAULT,
                                                       r, "nc"))
        layer["elements"] += K * N
        del w, wt, r
    torch.cuda.empty_cache()
    return dict(per_layer=layer, layers=cfg.n_layers,
                per_step={k: v * cfg.n_layers for k, v in layer.items()})


def serve_card_vs_cpu() -> dict:
    """A smoke config of each family (fp32, quantized kernels) with the same
    weights on the CPU (plain versions) and on the card: prefill and 8
    decode logits, the greedy tokens, and the card's launches against the
    closed form (the encoder-decoder's prompts carry 12 source frames)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.serve import ServeEngine

    out = {}
    for name in SERVE_MODELS:
        cfg = dataclasses.replace(get_smoke_config(name), quant_backend="pallas")
        cpu = init_lm(cfg, seed=3, device="cpu")
        gpu = copy.deepcopy(cpu).to("cuda")
        gen = torch.Generator().manual_seed(4)
        toks = torch.randint(0, cfg.vocab, (2, 12), generator=gen)
        prompts = lm_inputs(cfg, toks[:, :4], gen, 12)
        n = serve_linears(cfg, prefill=True) + 8 * serve_linears(cfg)
        logits, tokens = {}, {}
        for dev, model in (("cpu", cpu), ("cuda", gpu)):
            engine = ServeEngine(cfg, model, max_len=32, device=dev)
            reset_launch_counts()
            with torch.inference_mode():
                lg, cache = engine.prefill(prompts)
                steps = [lg]
                for i in range(4, 12):
                    lg, cache = engine.decode(cache, toks[:, i:i + 1].to(dev))
                    steps.append(lg)
            launched = launch_counts()
            logits[dev] = torch.stack(steps).cpu()
            tokens[dev] = engine.generate(prompts, 8).cpu()
        err = max_abs_err(logits["cuda"], logits["cpu"])
        scale = max(1.0, float(logits["cpu"].abs().max()))
        out[name] = dict(logits_max_abs=err, tolerance=SERVE_AGREE_TOL * scale,
                         tokens_equal=torch.equal(tokens["cuda"], tokens["cpu"]),
                         card_launches={k: launched[k] for k in ("mls_quantize_rows",
                                                                 "mls_matmul")})
        out[name]["agree"] = (err <= SERVE_AGREE_TOL * scale and out[name]["tokens_equal"]
                              and out[name]["card_launches"] == {"mls_quantize_rows": 2 * n,
                                                                 "mls_matmul": n})
    return out


# card against CPU on the smoke configs: the quantized linears are
# bit-exact, but the norms, attention and SSD sums reduce in other orders
# on the card, and one ulp before a quantizer can move an element to the
# neighbouring code (the CPU cross-tests against the JAX package hold the
# same logits to this bound)
SERVE_AGREE_TOL = 1e-3


def phase_serve(results: dict) -> dict[str, dict[str, int]]:
    """The LM serving path: SERVE_MODELS at full width on the card, K1 and
    K3 at the serving GEMMs, and card against CPU on the smoke configs.
    Returns each model's launches of its whole ``generate`` by kernel (the
    counts set to 0 just before that run and read just after it)."""
    smi = results["nvidia_smi"]
    served = {name: serve_model(name, smi) for name in SERVE_MODELS}
    timed: dict = {}
    checks = serve_kernel_checks(timed)
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         **{k: v for k, v in t.items() if k not in ("bytes", "ops")}))
        print(json.dumps({"serve_timing": rows[-1], "nvidia_smi": smi}))
    requant = weight_requant_ms()
    print(json.dumps({"serve_weight_requant_chatglm3": requant, "nvidia_smi": smi}))
    agree = serve_card_vs_cpu()
    print(json.dumps({"serve_agree": agree}))
    results["serve"] = dict(models=served, kernel_checks=checks, kernel_times=rows,
                            weight_requant=requant, agree=agree)
    bad = [c for c in checks if not c["identical"]]
    if bad:
        raise AssertionError(f"{len(bad)} serving-shape kernel results differ from their plain "
                             f"versions: {bad[:3]}")
    if not all(a["agree"] for a in agree.values() if a.get("held", True)):
        raise AssertionError(f"card and CPU disagree on the smoke configs: {agree}")
    return {name: r["launches_generate"] for name, r in served.items()}


# The lm_train phase: LM training (repro_torch.train.make_train_step) on the
# quantized kernels, quant_backend "pallas" (K1 on both operands and K3 for
# the forward, data-gradient and weight-gradient GEMM of every linear),
# stochastic rounding from fold_in(seed, step), bf16 compute and full remat
# as the FULL configs say, AdamW with the default cosine schedule (lr 0 at
# step 0), random weights from seed 0, train_4k's sequence (the
# encoder-decoder's encoder reads as many random frontend frames).
# name: (config overrides, batch, seq)
LM_TRAIN_STEPS = 4
LM_TRAIN_MODELS = {
    "chatglm3-6b": ({"n_layers": 8}, 2, 4096),
    "mamba2-370m": ({}, 4, 1024),
    "zamba2-7b": ({"n_layers": 12}, 2, 4096),
    "moonshot-v1-16b-a3b": ({"n_layers": 4}, 1, 4096),
    "seamless-m4t-medium": ({}, 2, 4096),
}
LM_TRAIN_CUTS = {
    "chatglm3-6b": "n_layers 28 -> 8 (all 28 with AdamW's state take ~100 GB); train_4k's "
                   "global batch 256 -> 2 (seq 4096)",
    "mamba2-370m": "train_4k's global batch 256 -> 4, seq 4096 -> 1024",
    "zamba2-7b": "n_layers 81 -> 12 (2 shared-block applications); train_4k's global batch "
                 "256 -> 2 (seq 4096)",
    "moonshot-v1-16b-a3b": "n_layers 48 -> 4 (2.95 G parameters: 47 GB with AdamW's 16 B "
                           "each); train_4k's global batch 256 -> 1 (seq 4096): at 2 the fp32 "
                           "logits over its 163840-word vocabulary (5.4 GB a copy, about 4 "
                           "live) would take the card past 80 GB",
    "seamless-m4t-medium": "train_4k's global batch 256 -> 2 (seq 4096, 4096 source frames); "
                           "full depth (12 + 12 layers)",
}
# the model whose run is checkpointed after step 2 and resumed
LM_TRAIN_CKPT = "mamba2-370m"


def lm_train_data(cfg, batch: int, seq: int):
    """The run's LM token stream on the card; the encoder-decoder's batches
    also carry ``src_emb`` (batch, seq, frontend_dim) for its encoder."""
    from repro_torch.data import make_lm_iterator

    extras = ((("src_emb", (batch, seq, cfg.frontend_dim)),) if cfg.family == "encdec"
              else ())
    return make_lm_iterator(batch, seq, cfg.vocab, extras=extras, device="cuda")


def _device_ms_by_name(prof) -> dict[str, float]:
    """Device ms by kernel name (the GPU annotations of the MoE experts'
    spans, core.lowbit.STACK_SPANS, left out)."""
    from torch.autograd import DeviceType

    from repro_torch.core.lowbit import STACK_SPANS

    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and e.name not in STACK_SPANS:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return by_name


def _experts_ms(prof) -> float:
    """Device ms of the MoE experts' fake-quant in a trace: the kernels
    that run inside the GPU annotations of core.lowbit.STACK_SPANS, the
    stacked fake-quant GEMM's forward and backward (one stream: the kernels
    between a span's first and last are its own).  The profiler's "CUDA
    total" of the spans' host ranges over-counts: it read 1253 ms for
    llama4-scout's decode step against 1142 ms of device busy (H100)."""
    from torch.autograd import DeviceType

    from repro_torch.core.lowbit import STACK_SPANS

    spans, kernels = [], []
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            (spans if e.name in STACK_SPANS else kernels).append(e.time_range)
    return sum(k.elapsed_us() for k in kernels
               if any(s.start <= k.start < s.end for s in spans)) / 1e3


def traced_train_step(step_fn, model, opt, batch) -> tuple:
    """One train step under torch.profiler: the host-clock step, device busy
    (the sum of kernel times), K1's and K3's kernel time, copies (the
    transposed operands qd_gemm makes contiguous, among others), the MoE
    experts' fake-quant (forward, its remat and backward: _experts_ms) and
    the device's idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model, opt, m = step_fn(model, opt, batch)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
    by_name = _device_ms_by_name(prof)
    device_ms = sum(by_name.values())
    if device_ms <= 0:
        raise AssertionError("the profiler recorded no device time")
    of = lambda names: sum(v for k, v in by_name.items()  # noqa: E731
                           if any(n.lower() in k.lower() for n in names))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    trace = dict(host_ms_under_profiler=host_ms, device_ms=device_ms,
                 k1_ms=of(DEVICE_KERNELS["mls_quantize_rows"]),
                 k3_ms=of(DEVICE_KERNELS["mls_matmul"]),
                 copy_ms=of(("copy", "Memcpy")), softmax_ms=of(("softmax",)),
                 experts_ms=_experts_ms(prof), device_idle_share=1.0 - device_ms / host_ms,
                 top_kernels_ms=[(k[:90], v) for k, v in top],
                 finite=bool(torch.isfinite(m["loss"])))
    return model, opt, trace


def lm_component_ms(cfg, batch: int, seq: int) -> dict:
    """The step's attention and LM head timed alone at its shapes (CUDA
    events, fresh random tensors): one attention forward, one forward and
    backward; the LM head with the loss forward and backward.  Per step,
    every attention use (an encoder-decoder's decoder layer has two) runs
    forward and backward, and under full remat its forward once more (the
    hybrid's shared block is not remat'd).  For an MoE, one layer's routed
    experts alone (the three stacked fake-quant GEMMs and the gate, at the
    dispatch's (E, B x capacity, d) rows), forward and forward + backward,
    likewise times the layers."""
    import torch
    import torch.nn.functional as F

    from repro_torch.configs.base import torch_dtype
    from repro_torch.core import fold_in
    from repro_torch.core.lowbit import lowbit_matmul_stack
    from repro_torch.models import nn as L

    gen = torch.Generator(device="cuda").manual_seed(11)
    out = {}
    if cfg.n_heads:
        q = torch.randn((batch, seq, cfg.n_heads, cfg.hd), generator=gen, device="cuda")
        k, v = (torch.randn((batch, seq, cfg.n_kv_heads, cfg.hd), generator=gen, device="cuda")
                for _ in range(2))
        qkv = [t.requires_grad_() for t in (q, k, v)]
        g = torch.randn_like(q)
        fwd = cuda_ms(lambda: L.gqa_attention(*qkv), iters=3, warmup=1)
        both = cuda_ms(lambda: torch.autograd.grad(L.gqa_attention(*qkv), qkv, g), iters=3,
                       warmup=1)
        uses = {"hybrid": cfg.n_layers // max(cfg.attn_every, 1),
                "encdec": cfg.enc_layers + 2 * cfg.n_layers}.get(cfg.family, cfg.n_layers)
        remat_fwd = uses if cfg.family != "hybrid" and cfg.remat == "full" else 0
        out.update(attention_fwd_ms=fwd, attention_fwd_bwd_ms=both, attention_uses=uses,
                   attention_ms_per_step=uses * both + remat_fwd * fwd)
        del q, k, v, qkv, g
    if cfg.family == "moe":
        e, d, f = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
        rows = batch * int(seq * cfg.top_k / e * cfg.capacity_factor + 1)
        xe = torch.randn((e, rows, d), generator=gen, device="cuda").to(
            torch_dtype(cfg.compute_dtype)).requires_grad_()
        ws = [(torch.randn(shape, generator=gen, device="cuda") * 0.02).requires_grad_()
              for shape in ((e, d, f), (e, d, f), (e, f, d))]
        qcfg, key = cfg.qcfg(), 12345

        def experts():
            g = lowbit_matmul_stack(xe, ws[0], fold_in(key, 0), qcfg)
            u = lowbit_matmul_stack(xe, ws[1], fold_in(key, 1), qcfg)
            h = (F.silu(g) * u).to(xe.dtype)
            return lowbit_matmul_stack(h, ws[2], fold_in(key, 2), qcfg)

        gy = torch.randn((e, rows, d), generator=gen, device="cuda")
        fwd = cuda_ms(experts, iters=3, warmup=1)
        both = cuda_ms(lambda: torch.autograd.grad(experts(), [xe] + ws, gy), iters=3, warmup=1)
        remat_fwd = cfg.n_layers if cfg.remat == "full" else 0
        out.update(experts_fwd_ms=fwd, experts_fwd_bwd_ms=both, experts_rows=(e, rows, d),
                   experts_ms_per_step=cfg.n_layers * both + remat_fwd * fwd)
        del xe, ws, gy
    x = torch.randn((batch, seq, cfg.d_model), generator=gen, device="cuda").to(
        torch_dtype(cfg.compute_dtype)).requires_grad_()
    head = (torch.randn((cfg.vocab, cfg.d_model), generator=gen, device="cuda") * 0.02
            ).requires_grad_()
    tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=gen, device="cuda")

    def head_and_loss():
        logits = x.float() @ head.to(x.dtype).float().t()  # lm.logits_fn
        lg = logits[:, :-1]
        ll = torch.gather(lg, -1, tokens[:, 1:, None])[..., 0]
        loss = (torch.logsumexp(lg, dim=-1) - ll).mean()
        return torch.autograd.grad(loss, (x, head))

    out["lm_head_and_loss_fwd_bwd_ms"] = cuda_ms(head_and_loss, iters=3, warmup=1)
    del x, head, tokens
    torch.cuda.empty_cache()
    return out


def lm_train_model(name: str, smi: str) -> dict:
    """Train one of LM_TRAIN_MODELS for LM_TRAIN_STEPS steps at full width:
    counts set to 0 just before the run and read just after; each step's
    launches, loss, grad norm and host time (train_step alone: its batch is
    drawn first, and that time kept apart); the weights unchanged by step
    1 (lr 0) and moved by step 2; one more step traced; chatglm3-6b also a
    step at microbatch 2; LM_TRAIN_CKPT checkpointed after step 2 on the
    card, restored on the card and resumed, its step 3 equal bit for bit."""
    import dataclasses
    import tempfile

    import torch

    from repro_torch.configs import SHAPES, RunConfig, get_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models.lm import init_lm
    from repro_torch.train import CheckpointManager, make_train_step

    over, batch, seq = LM_TRAIN_MODELS[name]
    cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
    if cfg.remat != "full" or cfg.compute_dtype != "bfloat16":
        raise AssertionError(f"{name}: expected full remat and bf16 compute, got {cfg.remat}, "
                             f"{cfg.compute_dtype}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run = RunConfig(model=cfg, shape=SHAPES["train_4k"])
    step_fn, opt_init = make_train_step(run)
    model = init_lm(cfg, seed=0, device="cuda")
    opt = opt_init(model)
    data = lm_train_data(cfg, batch, seq)
    params = dict(model.named_parameters())
    watched = ("emb", "layers.0." + ("in_proj.w" if cfg.family in ("ssm", "hybrid")
                                     else "attn.wq.w"))
    before_run = {k: params[k].detach().clone() for k in watched}
    want = lm_train_launches(cfg)
    ckpt_dir = tempfile.TemporaryDirectory() if name == LM_TRAIN_CKPT else None
    losses, gnorms, lrs, steps_ms, data_ms, per_step, moved, bad = [], [], [], [], [], [], [], []
    step3 = None

    reset_launch_counts()
    for i in range(LM_TRAIN_STEPS):
        before = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inputs = next(data)  # drawn on the host and put on the card
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        model, opt, m = step_fn(model, opt, inputs)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t1) * 1e3)
        data_ms.append((t1 - t0) * 1e3)
        gnorms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        per_step.append({k: launch_counts()[k] - before[k] for k in want})
        moved.append([not torch.equal(before_run[k], params[k]) for k in watched])
        if ckpt_dir is not None and i == 1:
            CheckpointManager(ckpt_dir.name).save(
                i + 1, {"params": model.state_dict(), "opt": opt, "data": data.state_dict()})
        if ckpt_dir is not None and i == 2:
            step3 = (losses[-1], {k: p.detach().clone() for k, p in params.items()})
    torch.cuda.synchronize()
    launched = launch_counts()

    model, opt, trace = traced_train_step(step_fn, model, opt, next(data))
    r = dict(config={k: getattr(cfg, k) for k in ("n_layers", "d_model", "n_heads",
                                                   "n_kv_heads", "d_ff", "vocab",
                                                   "compute_dtype", "remat")},
             cut=LM_TRAIN_CUTS[name], params=sum(p.numel() for p in params.values()),
             batch=batch, seq=seq, tokens_per_step=batch * seq, losses=losses,
             grad_norms=gnorms, lrs=lrs, steps_ms=steps_ms, data_ms=data_ms,
             median_step_ms=statistics.median(steps_ms[1:]), launches_per_step=per_step,
             expected_per_step=want, launches=launched, weights_moved=moved, trace=trace,
             nvidia_smi=smi)
    if name == "chatglm3-6b":  # the same run, one step at microbatch 2
        mb_fn, _ = make_train_step(dataclasses.replace(run, microbatch=2))
        before = launch_counts()
        model, opt, m = mb_fn(model, opt, next(data))
        r["microbatch2"] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                                launches={k: launch_counts()[k] - before[k] for k in want},
                                expected=lm_train_launches(cfg, microbatch=2))
        if not math.isfinite(r["microbatch2"]["loss"]):
            bad.append(f"microbatch-2 loss {r['microbatch2']['loss']}")
        if r["microbatch2"]["launches"] != r["microbatch2"]["expected"]:
            bad.append(f"microbatch-2 launches {r['microbatch2']['launches']}")
    r["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del model, opt, params, before_run, m
    torch.cuda.empty_cache()
    if ckpt_dir is not None:  # a fresh run restored from step 2 on the card
        model = init_lm(cfg, seed=1, device="cuda")
        opt = opt_init(model)
        data = lm_train_data(cfg, batch, seq)
        mgr = CheckpointManager(ckpt_dir.name)
        st = mgr.restore({"params": model.state_dict(), "opt": opt,
                          "data": data.state_dict()}, device="cuda")
        model.load_state_dict(st["params"])
        data.load_state_dict(st["data"])
        model, _, m = step_fn(model, st["opt"], next(data))
        same = float(m["loss"]) == step3[0] and all(
            torch.equal(p, step3[1][k]) for k, p in model.named_parameters())
        r["resume"] = dict(from_step=mgr.latest_step(), resumed_loss=float(m["loss"]),
                           uninterrupted_loss=step3[0], bit_identical=same)
        if not same:
            bad.append(f"the resumed step 3 differs from the uninterrupted one: {r['resume']}")
        del model, opt, st, step3
        ckpt_dir.cleanup()
        torch.cuda.empty_cache()
    r["components"] = lm_component_ms(cfg, batch, seq)
    print(f"lm_train {name} ({smi}): {r['params'] / 1e9:.3f} G params, losses {losses}, grad "
          f"norms {gnorms}, steps {[round(t, 1) for t in steps_ms]} ms (batches drawn in "
          f"{[round(t, 2) for t in data_ms]} ms before them), device busy "
          f"{trace['device_ms']:.1f} ms of {trace['host_ms_under_profiler']:.1f} (idle "
          f"{trace['device_idle_share']:.3f}), K1 {trace['k1_ms']:.1f} ms, K3 "
          f"{trace['k3_ms']:.1f} ms, copies {trace['copy_ms']:.1f} ms, experts' fake-quant "
          f"{trace['experts_ms']:.1f} ms, peak "
          f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches per step {per_step[0]}; "
          f"reduced: {r['cut']}")
    if not all(math.isfinite(v) for v in losses + gnorms) or not trace["finite"]:
        bad.append(f"non-finite loss or grad norm: {losses} {gnorms}")
    if any(moved[0]) or not all(moved[1]):
        bad.append(f"weights moved {moved}: expected none after step 1 (lr 0), all after 2")
    if any(p != want for p in per_step):
        bad.append(f"launches per step {per_step}, expected {want}")
    if {k: launched[k] for k in want} != {k: v * LM_TRAIN_STEPS for k, v in want.items()}:
        bad.append(f"the run launched {launched}, expected {want} x {LM_TRAIN_STEPS}")
    if bad:
        raise AssertionError(f"{name}: " + "; ".join(bad))
    return r


# K1 (stochastic, given bytes) and K3 are held to their plain versions at
# every training GEMM of the lm_train phase's models, each at its run's T =
# batch x seq tokens: for a quantized linear K -> N its forward (T, K, N),
# data gradient (T, N, K) and weight gradient (K, T, N), contracting over
# the tokens (T/128 scaling groups) with both operands transposed copies in
# qd_gemm.  The rows of LM_TRAIN_TIMED are also timed.
LM_TRAIN_TIMED = "chatglm3-6b"


def lm_train_gemms() -> dict[str, tuple]:
    """{label: (M, K, N, kind)}: the distinct (M, K, N) of every quantized
    linear of the LM_TRAIN_MODELS configs (as cut), read from the model
    built on the meta device; K is the contraction before qd_gemm pads it
    to K_BLOCK."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import nn as L
    from repro_torch.models.lm import LM

    out, seen = {}, set()
    for name, (over, batch, seq) in LM_TRAIN_MODELS.items():
        cfg = dataclasses.replace(get_config(name), quant_backend="pallas", **over)
        with torch.device("meta"):
            model = LM(cfg)
        t = batch * seq
        for mname, mod in model.named_modules():
            if (not isinstance(mod, L.Linear) or mname == "frontend_proj"
                    or mname.endswith("router")):  # unquantized
                continue
            k, n = mod.w.shape
            for kind, mkn in (("fwd", (t, k, n)), ("dgrad", (t, n, k)), ("wgrad", (k, t, n))):
                if (name, mkn) not in seen:
                    seen.add((name, mkn))
                    out[f"{name} {mname.split('.')[-1]} {kind}"] = (*mkn, kind)
    return out


def lm_train_kernel_checks(timed: dict) -> list[dict]:
    """K1 ("nc", <2,4>, stochastic: given rounding bytes to both) on both
    operands of each lm_train_gemms GEMM against quantize_ref, and K3 on
    those codes against mls_matmul_ref on the plan matmul_plan picks and on
    the other variant; each operand zero-padded along K to K_BLOCK as
    qd_gemm pads it.  The LM_TRAIN_TIMED rows are timed (the plain versions
    on 3 calls), with, for the weight gradient, the transposed copy qd_gemm
    makes of each operand."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT
    from repro_torch.kernels import mls_matmul, mls_quantize
    from repro_torch.kernels.mls_matmul import matmul_plan, sg_shapes
    from repro_torch.kernels.ref import mls_matmul_ref, quantize_ref

    fmt, kb = FMT_IMAGENET, K_BLOCK
    gen = torch.Generator(device="cuda").manual_seed(9)
    checks = []
    for sname, (M, K, N, kind) in lm_train_gemms().items():
        timing = sname.startswith(LM_TRAIN_TIMED)
        pk = (-K) % kb
        coded = {}
        for oname, rows in (("x", M), ("w^T", N)):
            if kind == "wgrad":  # the operand as the step holds it, copied transposed
                src = torch.randn((K, rows), generator=gen, device="cuda")
                t = F.pad(src.t(), (0, pk)).contiguous()
                if timing:
                    timed[("transpose_copy", sname, oname)] = dict(
                        ms=cuda_ms(lambda src=src: F.pad(src.t(), (0, pk)).contiguous()),
                        bytes=8 * src.numel(), ops=0, shape=f"lm_train {sname} {oname} "
                        f"{tuple(src.shape)}^T")
                del src
            else:
                t = F.pad(torch.randn((rows, K), generator=gen, device="cuda"), (0, pk))
            r = torch.randint(0, 256, t.shape, generator=gen, dtype=torch.uint8, device="cuda")
            got = mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            want = quantize_ref(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")
            torch.cuda.synchronize()
            err = max(max_abs_err(a, b) for a, b in zip(got, want))
            checks.append(dict(kernel="mls_quantize_rows", shape=f"lm_train {sname} {oname}",
                               operand=tuple(t.shape), identical=all(
                                   torch.equal(a, b) for a, b in zip(got, want)),
                               max_abs_err=err))
            run = lambda t=t, r=r: mls_quantize(t, fmt, kb, GS_FMT_DEFAULT, r, "nc")  # noqa: E731
            if timing:
                timed[("mls_quantize_rows", sname, oname)] = dict(
                    ms=cuda_ms(run),
                    kernel_ms=kernel_ms(run, DEVICE_KERNELS["mls_quantize_rows"]),
                    plain_ms=cuda_ms(lambda t=t, r=r: quantize_ref(t, fmt, kb, GS_FMT_DEFAULT,
                                                                   r, "nc"), iters=3, warmup=1),
                    # x and its rounding bytes read, codes and scales written
                    bytes=t.numel() * 6 + got[1].numel() * 4 + 4, ops=0, max_abs_err=err,
                    shape=f"lm_train {sname} {oname} {tuple(t.shape)}")
            coded[oname] = got
            del t, r, want
        (xc, xsg, xst), (wc, wsg, wst) = coded["x"], coded["w^T"]
        args = (xc, xsg, xst, wc.t(), wsg.t(), wst, fmt, kb)
        want = mls_matmul_ref(*args)
        plan = matmul_plan(M, N, K + pk, kb, fmt)
        plans = [plan, dataclasses.replace(plan, variant="walk" if plan.variant == "split"
                                           else "split")]
        errs = []
        for p in plans:
            got = mls_matmul(*args, "nc", plan=p)
            torch.cuda.synchronize()
            errs.append(max_abs_err(got, want))
            checks.append(dict(kernel="mls_matmul", shape=f"lm_train {sname}", mkn=(M, K, N),
                               plan=dataclasses.asdict(p), chosen=p == plan,
                               identical=torch.equal(got, want), max_abs_err=errs[-1],
                               finite=bool(torch.isfinite(got).all())))
            del got
        if timing:
            xs_shape, ws_shape = sg_shapes("nc", M, N, (K + pk) // kb)
            run = lambda p: lambda: mls_matmul(*args, "nc", plan=p)  # noqa: E731
            timed[("mls_matmul", sname)] = dict(
                ms=cuda_ms(run(plan)),
                kernel_ms=kernel_ms(run(plan), DEVICE_KERNELS["mls_matmul"]),
                other_plan=plans[1].variant, other_ms=cuda_ms(run(plans[1])),
                other_kernel_ms=kernel_ms(run(plans[1]), DEVICE_KERNELS["mls_matmul"]),
                plain_ms=cuda_ms(lambda: mls_matmul_ref(*args), iters=3, warmup=1),
                bytes=(M + N) * (K + pk) + 4 * (math.prod(xs_shape) + math.prod(ws_shape))
                + 4 * M * N + 8, ops=2 * M * N * (K + pk), max_abs_err=errs[0],
                plan=dataclasses.asdict(plan),
                shape=f"lm_train {sname} ({M}x{K}x{N}) {plan.variant}")
        del coded, args, want
        torch.cuda.empty_cache()
    return checks


# card against CPU on smoke configs (lm_loss and its gradients, key None,
# fp32): without quantization only the sums' order differs (1e-4 relative
# for the loss and each gradient's L2 norm); on the kernels one ulp before a
# quantizer can move an element to the neighbouring code, which moves a
# gradient by up to a few percent (the CPU cross-tests saw 1.6% on one
# weight against the JAX package), so there 1e-4 for the loss and 5e-2 per
# gradient.  With every quantizer fed the CPU's operands no code can move,
# so the card is held to the unquantized bound ("pallas fed").
LM_TRAIN_AGREE = {"off": (1e-4, 1e-4), "pallas": (1e-4, 5e-2), "pallas fed": (1e-4, 1e-4)}
# Seeds at which the new families' unfed gap is read (twice each) and
# reported: one code moved early cascades through every later quantizer,
# so that gap is ~1e-6 at most seeds and percents at a few.  It is held
# to "pallas" for every family but the encoder-decoder, whose smoke config
# moves 5.4% at seed 3 (PERF.md); that one is held through its fed run.
UNFED_SEEDS = (3, 4, 5, 6, 7)


class fed_operands:
    """Within: every quantizer of the LM's linears (``qd_gemm``'s two
    operands, ``quantize_stack``'s one) appends its operands to ``ops``
    as CPU copies or, with ``feed``, takes the next ones of ``ops`` in
    their place (those of the same work run before, on any device)."""

    def __init__(self, ops: list, feed: bool):
        from repro_torch.core import lowbit
        from repro_torch.kernels import lowbit_conv

        self.ops, self.feed, self.used = ops, feed, 0
        self.sites = [(lowbit_conv, "qd_gemm", 2), (lowbit, "quantize_stack", 1)]
        self.real = [getattr(mod, attr) for mod, attr, _ in self.sites]

    def _spy(self, attr: str, n: int, real):
        def spy(*args, **kwargs):
            head = args[:n]
            if self.feed:
                tag, fed = self.ops[self.used]
                self.used += 1
                if tag != attr or [t.shape for t in fed] != [t.shape for t in head]:
                    raise RuntimeError(f"fed_operands: call {self.used} is {attr} "
                                       f"{[tuple(t.shape) for t in head]}, the record's {tag}")
                head = tuple(t.to(h.device) for t, h in zip(fed, head))
            else:
                self.ops.append((attr, tuple(t.detach().cpu().clone() for t in head)))
            return real(*head, *args[n:], **kwargs)
        return spy

    def __enter__(self):
        for (mod, attr, n), real in zip(self.sites, self.real):
            setattr(mod, attr, self._spy(attr, n, real))
        return self

    def __exit__(self, *exc):
        for (mod, attr, _), real in zip(self.sites, self.real):
            setattr(mod, attr, real)
        if exc[0] is None and self.feed and self.used != len(self.ops):
            raise RuntimeError(f"fed_operands: {self.used} of {len(self.ops)} recorded calls made")


def lm_card_vs_cpu(name: str, backend: str, seed: int = 3, fed: bool = False) -> dict:
    """lm_loss and its gradients with key None, the same weights (from
    ``seed``) and batch (from ``seed + 1``) on the CPU (plain versions)
    and on the card, for the smoke config of ``name``; with ``fed`` every
    quantizer on the card takes the CPU run's operands (fed_operands)."""
    import copy
    import dataclasses

    import torch

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import lm

    over = {"quant": False} if backend == "off" else {"quant_backend": backend}
    cfg = dataclasses.replace(get_smoke_config(name), **over)
    cpu = lm.init_lm(cfg, seed=seed, device="cpu")
    models = {"cpu": cpu, "cuda": copy.deepcopy(cpu).to("cuda")}
    gen = torch.Generator().manual_seed(seed + 1)
    batch = lm_inputs(cfg, torch.randint(0, cfg.vocab, (2, 32), generator=gen), gen, 32)
    ops: list = []
    res = {}
    for dev, model in models.items():
        reset_launch_counts()
        with fed_operands(ops, feed=dev == "cuda") if fed else contextlib.nullcontext():
            loss, _ = lm.lm_loss(model, {k: v.to(dev) for k, v in batch.items()}, None)
            loss.backward()
        res[dev] = (float(loss.detach()),
                    {k: p.grad.cpu() for k, p in model.named_parameters()})
        if dev == "cuda":
            launched = launch_counts()
    rel = {k: float((res["cuda"][1][k] - g).double().norm()
                    / max(float(g.double().norm()), 1e-30))
           for k, g in res["cpu"][1].items()}
    worst = max(rel, key=rel.get)
    loss_rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    want = lm_train_launches(cfg) if backend == "pallas" else {
        "mls_quantize_rows": 0, "mls_matmul": 0}
    loss_tol, grad_tol = LM_TRAIN_AGREE[f"{backend} fed" if fed else backend]
    return dict(loss_cpu=res["cpu"][0], loss_cuda=res["cuda"][0], loss_rel=loss_rel,
                worst_grad_rel=rel[worst], worst_grad=worst, tolerance=(loss_tol, grad_tol),
                fed_calls=len(ops), card_launches={k: launched[k] for k in want},
                agree=loss_rel <= loss_tol and rel[worst] <= grad_tol
                and {k: launched[k] for k in want} == want)


def lm_train_card_vs_cpu() -> dict:
    """:func:`lm_card_vs_cpu` for the smoke configs of LM_TRAIN_MODELS on
    the kernels, as run and fed, and of chatglm3-6b unquantized; for the
    families this phase added (moe, encdec) the unfed gap at UNFED_SEEDS,
    read twice."""
    from repro_torch.configs import get_smoke_config

    out = {}
    for name in LM_TRAIN_MODELS:
        family = get_smoke_config(name).family
        out[f"{name} pallas"] = res = lm_card_vs_cpu(name, "pallas")
        out[f"{name} pallas fed"] = lm_card_vs_cpu(name, "pallas", fed=True)
        if family in ("moe", "encdec"):
            res["unfed_by_seed"] = {
                seed: [lm_card_vs_cpu(name, "pallas", seed)["worst_grad_rel"] for _ in range(2)]
                for seed in UNFED_SEEDS}
        res["held"] = family != "encdec"  # the encoder-decoder's is reported only
    out["chatglm3-6b off"] = lm_card_vs_cpu("chatglm3-6b", "off")
    return out


def phase_lm_train(results: dict) -> dict[str, dict[str, int]]:
    """LM training: LM_TRAIN_MODELS at full width on the card, K1 and K3 at
    chatglm3-6b's training GEMMs, and card against CPU on the smoke configs.
    Returns each model's launches of its LM_TRAIN_STEPS-step run by kernel
    (the counts set to 0 just before that run and read just after it)."""
    smi = results["nvidia_smi"]
    trained = {name: lm_train_model(name, smi) for name in LM_TRAIN_MODELS}
    timed: dict = {}
    checks = lm_train_kernel_checks(timed)
    rows = []
    for (kernel, *_), t in timed.items():
        bound_bytes = t["bytes"] / HBM_BYTES_PER_S * 1e3
        bound_ops = t["ops"] / INT8_OPS_PER_S * 1e3
        rows.append(dict(name=kernel, bound_ms=max(bound_bytes, bound_ops),
                         bound_by="bytes" if bound_bytes >= bound_ops else "operations",
                         **{k: v for k, v in t.items() if k not in ("bytes", "ops")}))
        print(json.dumps({"lm_train_timing": rows[-1], "nvidia_smi": smi}))
    agree = lm_train_card_vs_cpu()
    print(json.dumps({"lm_train_agree": agree}))
    results["lm_train"] = dict(models=trained, kernel_checks=checks, kernel_times=rows,
                               agree=agree)
    bad = [c for c in checks if not c["identical"]]
    if bad:
        raise AssertionError(f"{len(bad)} training-shape kernel results differ from their "
                             f"plain versions: {bad[:3]}")
    if not all(a["agree"] for a in agree.values() if a.get("held", True)):
        raise AssertionError(f"card and CPU disagree on the smoke configs: {agree}")
    return {name: r["launches"] for name, r in trained.items()}


SWEEP_REPEAT = ("resnet20/fp32/fake_quant", "resnet20/mls_e2m1/pallas")  # run twice


def sweep_cell(cell, convs) -> dict:
    """Train one chip-grid cell on the card, counts set to 0 just before
    and read just after; every step's launches must equal the dispatch's
    count over ResNet-20's 20 quantized convs ("pallas": K1/K3 for "nc",
    K2/K3 for "c" and "none") or none at all (fake_quant, fp32), and every
    loss must be finite.  Step time: host clock, each step ending in a read
    of its loss; median of steps 2-40."""
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.sweep.runner import cell_qcfg, cell_row, train_cell

    zero = dict.fromkeys(launch_counts(), 0)
    want = expected_launches(cell_qcfg(cell), convs) if cell.backend == "pallas" else zero
    reset_launch_counts()
    t0 = time.perf_counter()
    traj = train_cell(cell, "cuda")
    wall = time.perf_counter() - t0
    counts = launch_counts()
    row = cell_row(cell, traj, wall)
    r = dict(row=row, losses=traj.losses, accs=traj.accs, wall_s=wall,
             median_step_ms=statistics.median(traj.step_s[1:]) * 1e3,
             first_step_ms=traj.step_s[0] * 1e3, launches=counts, expected_per_step=want)
    print(f"sweep {row['cell_id']}: loss {row['final_loss']} acc {row['final_acc']} median "
          f"step {r['median_step_ms']:.2f} ms wall {wall:.1f} s launches {counts}")
    if not all(math.isfinite(v) for v in traj.losses):
        raise AssertionError(f"{row['cell_id']}: non-finite loss {traj.losses}")
    for i, per in enumerate(traj.launches):
        if per != want:
            raise AssertionError(f"{row['cell_id']} step {i}: launches {per}, expected {want}")
    return r


def phase_sweep(results: dict) -> dict[str, dict[str, int]]:
    """The frontier sweep's chip grid (``repro_torch.sweep.chip_grid``:
    ResNet-20 at full width, CIFAR 32x32, batch 128, lr 0.05, 40 steps;
    fp32, <2,4>, <2,1> and <0,4> on fake_quant, <2,4> and <2,1> on the
    kernels, <2,1> on the kernels with grouping "c" and "none"), each cell
    seeded by its own generators; the frontier table; the gate against
    the committed chip entries of the port's baseline, which must pass, and
    its two negative controls, which must fail; two cells run again, which
    must take the same steps (the runner's cuDNN is deterministic), and
    the fp32 cell twice with cuDNN's default algorithms (reported); then
    the Table II benchmark (quick).  Returns each kernel's launches per step by "pallas" cell."""
    import importlib.util
    from unittest import mock

    from repro_torch.sweep import apply_gate, chip_grid, frontier_table, load_baseline
    from repro_torch.sweep import runner as sweep_runner
    from repro_torch.sweep.gate import SABOTAGE_MODES, sabotage_baseline

    convs = conv_list("resnet20", HW, BATCH)
    cells = {c.cell_id(): c for c in chip_grid()}
    runs = {cid: sweep_cell(c, convs) for cid, c in cells.items()}
    nc = {"mls_quantize_rows": 120, "mls_quantize_given_sg": 0, "mls_matmul": 60,
          "implicit_conv": 0, "conv_tensor_scale": 0, "sabotage_overlap": 0}
    for cid in ("resnet20/mls_e2m4/pallas", "resnet20/mls_e2m1/pallas"):
        if runs[cid]["expected_per_step"] != nc:
            raise AssertionError(f"{cid} no longer takes 120 K1 and 60 K3 launches a step "
                                 f"on im2col alone: {runs[cid]['expected_per_step']}")
    rows = [r["row"] for r in runs.values()]
    results["sweep"] = sweep = dict(cells=runs)
    print(frontier_table(rows, title="Bit-width x architecture frontier (chip grid, "
                                     f"{results['nvidia_smi']})"))
    baseline = load_baseline()
    failures = apply_gate(rows, baseline, grid_name="chip")
    sabotaged = {mode: apply_gate(rows, sabotage_baseline(baseline, mode, "chip"), "chip")
                 for mode in SABOTAGE_MODES}
    repeat = {}
    for cid in SWEEP_REPEAT:
        again = sweep_cell(cells[cid], convs)
        repeat[cid] = dict(losses_equal=again["losses"] == runs[cid]["losses"],
                           max_loss_diff=max(abs(a - b) for a, b in
                                             zip(again["losses"], runs[cid]["losses"])))
    # the control: cuDNN's default algorithms, which the runner replaces
    with mock.patch.object(sweep_runner, "_deterministic_cudnn", contextlib.nullcontext):
        a, b = (sweep_cell(cells[SWEEP_REPEAT[0]], convs) for _ in range(2))
    repeat["cudnn_default"] = dict(losses_equal=a["losses"] == b["losses"],
                                   max_loss_diff=max(abs(x - y) for x, y in
                                                     zip(a["losses"], b["losses"])),
                                   median_step_ms=(a["median_step_ms"], b["median_step_ms"]))
    print(json.dumps({"sweep_repeat": repeat}))
    spec = importlib.util.spec_from_file_location(
        "torch_table2_accuracy", ROOT / "benchmarks" / "torch_table2_accuracy.py")
    table2 = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(table2)
    t = time.perf_counter()
    t2_rows = table2.run(quick=True, device="cuda")
    t2_s = time.perf_counter() - t
    for r in t2_rows:
        print(f'{r["name"]},{r["us_per_call"]:.1f},"{r["derived"]}"')
    sweep.update(gate_failures=failures, sabotaged=sabotaged, repeat=repeat, table2=t2_rows,
                 table2_s=t2_s)
    print(json.dumps({"sweep_gate": failures or "pass",
                      "sabotaged": {m: len(f) for m, f in sabotaged.items()}}))
    if failures:
        raise AssertionError(f"sweep gate failed: {failures}")
    if not all(sabotaged.values()):
        raise AssertionError(f"a sabotaged baseline passed the gate: {sabotaged}")
    if not all(repeat[cid]["losses_equal"] for cid in SWEEP_REPEAT):
        raise AssertionError(f"a cell run again on the card took other steps: {repeat}")
    bad = [r["name"] for r in t2_rows
           if r["final_loss"] is None or not math.isfinite(r["final_loss"])]
    if bad:
        raise AssertionError(f"Table II variants with non-finite loss: {bad}")
    return {cid: r["expected_per_step"] for cid, r in runs.items()
            if cells[cid].backend == "pallas"}


def _tensors(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return [tree] if hasattr(tree, "device") else []


def k5_checks() -> dict:
    """K5 on the card against its plain version on the same inputs, timed.
    Launches made here are comparisons: they do not count for the path."""
    import torch

    from repro_torch.analysis.kernel_verify import writers_per_block
    from repro_torch.kernels.ref import sabotage_overlap_ref, sabotage_overlap_tiles
    from repro_torch.kernels.sabotage import launch_spec, sabotage_overlap_matmul

    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.randn((8, 16), generator=gen, device="cuda")
    w = torch.randn((16, 32), generator=gen, device="cuda")
    probe = torch.zeros((8, 32), dtype=torch.int32, device="cuda")
    got = sabotage_overlap_matmul(x, w, probe)
    tiles = sabotage_overlap_tiles(x, w)
    _, writes = sabotage_overlap_ref(x, w)
    torch.cuda.synchronize()
    writers = writers_per_block(launch_spec(8, 16, 32, "cuda"), "outputs[0]")[0].tolist()
    stores = [sorted(set(probe[:, 8 * c : 8 * c + 8].flatten().tolist())) for c in range(4)]
    nan_gaps, from_writer, err, last_writer = True, True, 0.0, 0
    for c in range(4):
        block = got[:, 8 * c : 8 * c + 8]
        if writers[c] == 0:
            nan_gaps &= bool(torch.isnan(block).all())
            continue
        first, last = tiles[(0, c)], tiles[(0, c + 1)]
        bits = block.view(torch.int32)
        is_last = bits == last.view(torch.int32)
        from_writer &= bool((is_last | (bits == first.view(torch.int32))).all())
        last_writer += int(is_last.sum())
        err = max(err, float(torch.minimum((block - first).abs(), (block - last).abs()).max()))
    ok = (writers == [2, 0, 2, 0] and stores == [[w_] for w_ in writers] and nan_gaps
          and from_writer and torch.equal(probe, writes))
    out = dict(writers_per_block=writers, probe_by_block_column=stores, nan_gaps=nan_gaps,
               each_element_from_a_writer=from_writer,
               elements_from_the_last_writer=last_writer, max_abs_err=err, identical=ok,
               ms=cuda_ms(lambda: sabotage_overlap_matmul(x, w)),
               kernel_ms=kernel_ms(lambda: sabotage_overlap_matmul(x, w),
                                   "sabotage_overlap_kernel"),
               plain_ms=cuda_ms(lambda: sabotage_overlap_ref(x, w)),
               bytes=4 * (x.numel() + w.numel() + got.numel()), ops=2 * 8 * 32 * 16)
    print(json.dumps({"k5": out}))
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: {out}")
    return out


def phase_audit(results: dict) -> tuple[dict, int]:
    """K5 checked; the clean audit at full width; the four sabotage modes.
    Returns K5's timing row and its launches in the overlap_write run."""
    from repro_torch.analysis import audit
    from repro_torch.kernels import launch_counts, reset_launch_counts

    k5 = k5_checks()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    t = time.perf_counter()
    path = out_dir / "AUDIT_torch_report.json"
    rc = audit.main(["--graph", "train", "--kernels", "--gate", "--out", str(path)])
    seconds = time.perf_counter() - t
    report = json.loads(path.read_text())
    graphs = report["graphs"]
    recorded = {name: report["kernels"]["kernels"][name] for name in graphs}
    # the fp32 MACs of a full-width step: the stem conv (forward, weight
    # gradient) and the classifier (forward, two gradients); a classifier
    # that missed the backward, which runs on autograd's device thread,
    # would count fewer
    fp = 2 * BATCH * 16 * HW * HW * 3 * 9 + 3 * BATCH * 64 * 10
    summary = dict(rc=rc, seconds=seconds, gate_pass=report["gate"]["pass"],
                   quantized_fraction={n: g["coverage"]["quantized_fraction"]
                                       for n, g in graphs.items()},
                   full_precision_macs={n: g["coverage"]["full_precision_macs"]
                                        for n, g in graphs.items()},
                   launches_per_step={n: g["launches"] for n, g in graphs.items()},
                   distinct_specs=report["kernels"]["distinct_launch_specs"],
                   recorded_specs={n: r["num_launch_specs"] for n, r in recorded.items()},
                   recorded_kernels={n: sorted({c["kernel"].split(" ")[1].split("[")[0]
                                                for c in r["calls"]})
                                     for n, r in recorded.items()})
    print(json.dumps({"audit": summary}))
    bad = []
    if rc != 0 or not report["gate"]["pass"]:
        bad.append(f"clean audit failed: {report['gate']['failures']}")
    if set(graphs) != {"train:resnet20", "train:resnet20@kb144"}:
        bad.append(f"graphs {sorted(graphs)}")
    if any(f < 0.99 for f in summary["quantized_fraction"].values()):
        bad.append(f"quantized fraction {summary['quantized_fraction']}")
    if any(v != fp for v in summary["full_precision_macs"].values()):
        bad.append(f"fp32 MACs {summary['full_precision_macs']}, expected {fp}")
    k1_k3 = ["mls_matmul_sum", "mls_matmul_terms", "mls_matmul_walk", "quantize_amax",
             "quantize_groups_warp"]
    want = {"train:resnet20": k1_k3,
            "train:resnet20@kb144": sorted(k1_k3 + ["conv_amax", "implicit_conv"])}
    if summary["recorded_kernels"] != want:
        bad.append(f"recorded kernels {summary['recorded_kernels']}")
    # exactly the closed form of tests/test_torch_analysis.py: K3's MACs are
    # counted once per call, whatever its plan launches
    if summary["quantized_fraction"] != {"train:resnet20": 0.996968,
                                         "train:resnet20@kb144": 0.997035}:
        bad.append(f"quantized fraction {summary['quantized_fraction']} is not the closed form")
    # the stage-1 weight gradient's term phase: a parallel grid over the card
    stage1 = [c for c in recorded["train:resnet20"]["calls"]
              if "mls_matmul_terms[" in c["kernel"]
              and c["grid"] == [["tile_m", 3], ["tile_n", 1], ["group", BATCH * HW * HW // K_BLOCK]]]
    summary["stage1_wgrad_term_programs"] = [math.prod(n for _, n in c["grid"]) for c in stage1]
    if not stage1 or not all(c["ok"] and math.prod(n for _, n in c["grid"]) >= 132
                             for c in stage1):
        bad.append(f"stage-1 weight gradient term phase not recorded as a proven grid of >= 132 "
                   f"programs: {stage1}")
    # the serve graph: one quantized decode step of qwen2-72b's smoke config
    # (batch 4, cache 128); its fraction is the closed form of
    # tests/test_torch_analysis.py
    path = out_dir / "AUDIT_torch_serve.json"
    rc = audit.main(["--graph", "serve", "--kernels", "--gate", "--out", str(path)])
    serve = json.loads(path.read_text())
    entry = serve["graphs"]["serve:qwen2-72b"]
    summary["serve_graph"] = dict(rc=rc, gate_pass=serve["gate"]["pass"],
                                  quantized_fraction=entry["coverage"]["quantized_fraction"],
                                  launches=entry["launches"],
                                  kernels_ok=serve["kernels"]["kernels"]["serve:qwen2-72b"]["ok"])
    print(json.dumps({"audit_serve": summary["serve_graph"]}))
    if (rc != 0 or not serve["gate"]["pass"] or not summary["serve_graph"]["kernels_ok"]
            or summary["serve_graph"]["quantized_fraction"] != 0.619048
            or entry["launches"] != 42):
        bad.append(f"serve audit: {summary['serve_graph']}, {serve['gate']['failures']}")
    sabotage = {}
    k5_launches = 0
    for mode, graph, named in (
            ("overlap_write", "none", ("overlap violation at outputs[0]",
                                       "gap violation at outputs[0]")),
            ("deep_k", "none", ("overflow violation",)),
            ("drop_halo", "none", ("oob violation at window_grid",)),
            ("fp32_gemm", "train", ("train:resnet20: quantized fraction",
                                    "train:resnet20@kb144: quantized fraction"))):
        path = out_dir / f"AUDIT_torch_{mode}.json"
        args = ["--graph", graph, "--gate", "--sabotage", mode, "--out", str(path)]
        if graph == "none":
            args.append("--kernels")
        reset_launch_counts()  # overlap_write: K5's launches in this run
        rc = audit.main(args)
        if mode == "overlap_write":
            k5_launches = launch_counts()["sabotage_overlap"]
        failures = json.loads(path.read_text())["gate"]["failures"]
        named_ok = all(any(n in f for f in failures) for n in named)
        sabotage[mode] = dict(rc=rc, named=named_ok, failures=failures[:4])
        if rc != 1 or not named_ok:
            bad.append(f"sabotage {mode}: rc {rc}, failures {failures}")
    summary["sabotage"] = sabotage
    summary["k5_launches_under_overlap_write"] = k5_launches
    results["audit"] = summary
    results["k5"] = k5
    print(json.dumps({"sabotage": sabotage}))
    if k5_launches != 1:
        bad.append(f"overlap_write launched K5 {k5_launches} times, expected 1")
    if bad:
        raise AssertionError("; ".join(bad))
    bound_bytes = k5["bytes"] / HBM_BYTES_PER_S * 1e3
    bound_ops = k5["ops"] / FP32_OPS_PER_S * 1e3
    row = dict(name="sabotage_overlap", shape="x (8, 16) @ w (16, 32)", ms=k5["ms"],
               plain_ms=k5["plain_ms"], bound_ms=max(bound_bytes, bound_ops),
               bound_by="bytes" if bound_bytes >= bound_ops else "operations",
               max_abs_err=k5["max_abs_err"], kernel_ms=k5["kernel_ms"])
    return row, k5_launches


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
    from repro_torch.kernels import build
    from repro_torch.runtime import resolve_device
    from repro_torch.sweep.record import nvidia_smi

    smi_line = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi_line}")

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

    rows, launches, serve_launches, lm_train_launches_, sweep_launches = [], {}, {}, {}, {}
    for name, phase in (("kernels", phase_kernels), ("train", phase_train),
                        ("trace", phase_trace), ("agree", phase_agree),
                        ("audit", phase_audit), ("zoo", phase_zoo),
                        ("fake_quant", phase_fakequant), ("driver", phase_driver),
                        ("serve", phase_serve), ("lm_train", phase_lm_train),
                        ("sweep", phase_sweep)):
        t = time.perf_counter()
        try:
            out = phase(results)
            if name == "kernels":
                rows = out
            elif name == "train":
                launches = out
            elif name == "audit":
                rows.append(out[0])
                launches["sabotage_overlap"] = out[1]
            elif name == "serve":
                serve_launches = out
            elif name == "lm_train":
                lm_train_launches_ = out
            elif name == "sweep":
                sweep_launches = out
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
    for r in rows:  # the first row timed at each kernel's reported shape
        if (not r["shape"].startswith(REPORTED_SHAPE[r["name"]])
                or any(k["name"] == r["name"] for k in kernels)):
            continue
        source, replaces = KERNELS[r["name"]]
        kernels.append(dict(name=r["name"], route="cuda", source=source, replaces=replaces,
                            launches=launches.get(r["name"], 0),
                            serve_launches={m: n.get(r["name"], 0)
                                            for m, n in serve_launches.items()},
                            lm_train_launches={m: n.get(r["name"], 0)
                                               for m, n in lm_train_launches_.items()},
                            sweep_launches={c: n.get(r["name"], 0)
                                            for c, n in sweep_launches.items()},
                            max_abs_err=r["max_abs_err"],
                            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None, shape=r["shape"],
                            **{k: r[k] for k in ("im2col_ms", "kernel_ms") if k in r}))
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
