"""Train ResNet-20 on synthetic CIFAR-like data with the MLS low-bit
training framework, beside the fp32 baseline (the paper's own experiment
at a chosen scale; the port's counterpart of
``examples/train_cifar_lowbit.py``).

Checkpointing and straggler monitoring are not ported yet (ROADMAP.md
queue 1, item 11).
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics
import time

import torch
import torch.nn.functional as F

from repro_torch.core.formats import EMFormat
from repro_torch.core.lowbit import QuantConfig, fold_in
from repro_torch.data.synthetic import CifarIterator
from repro_torch.kernels import launch_counts
from repro_torch.models.cnn import CNNConfig, init_resnet
from repro_torch.optim.optimizers import set_lr, sgdm, step_decay_schedule
from repro_torch.runtime import resolve_device

__all__ = ["DEFAULT_FMTS", "TrainResult", "main", "parse_fmt", "preset", "train_variant"]

_ROUNDING_SEED = 7  # as examples/train_cifar_lowbit.py: fold_in(key(7), step)
DEFAULT_FMTS = ("2,4", "2,1")  # the paper's <2,4> and <2,1>, beside fp32


@dataclasses.dataclass
class TrainResult:
    name: str
    losses: list[float] = dataclasses.field(default_factory=list)
    accs: list[float] = dataclasses.field(default_factory=list)
    step_s: list[float] = dataclasses.field(default_factory=list)
    # CUDA kernel launches of each step, by kernel
    launches: list[dict[str, int]] = dataclasses.field(default_factory=list)


def train_variant(
    name: str,
    qcfg: QuantConfig | None,
    steps: int,
    width: float = 1.0,
    hw: int = 32,
    batch: int = 128,
    seed: int = 0,
    device: str | torch.device = "cuda",
    log=print,
) -> TrainResult:
    """Train a fresh ResNet-20 (weights from ``seed``) for ``steps`` SGD
    steps; ``qcfg`` None is the fp32 baseline.  Runs on CUDA unless
    ``device="cpu"``."""
    device = resolve_device(device)
    model = init_resnet(CNNConfig("resnet20", width_mult=width, in_hw=hw), seed, device)
    opt = sgdm(model.parameters(), lr=0.05)
    lr_fn = step_decay_schedule(0.05, [steps // 2, 3 * steps // 4])
    data = CifarIterator(batch, hw, seed=seed, device=device)
    res = TrainResult(name)
    for i in range(steps):
        b = next(data)
        before = launch_counts()
        t0 = time.perf_counter()
        set_lr(opt, lr_fn(i))
        logits = model(b["image"], qcfg, fold_in(_ROUNDING_SEED, i))
        loss = F.cross_entropy(logits, b["label"])
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        acc = (logits.argmax(-1) == b["label"]).float().mean()
        loss_v, acc_v = float(loss.detach()), float(acc)  # waits for the device
        res.step_s.append(time.perf_counter() - t0)
        res.losses.append(loss_v)
        res.accs.append(acc_v)
        res.launches.append({k: v - before[k] for k, v in launch_counts().items()})
        log(f"  [{name}] step {i + 1}: loss={loss_v:.4f} acc={acc_v:.3f} "
            f"({res.step_s[-1] * 1e3:.1f} ms)")
    return res


def parse_fmt(s: str) -> EMFormat:
    """``"E,M"`` -> :class:`EMFormat`."""
    e, m = (int(v) for v in s.split(","))
    return EMFormat(e, m)


def preset(fmt: EMFormat) -> QuantConfig:
    """The trainer's quantized variant: the paper's setting, k_block 128,
    grouping "nc", stochastic rounding."""
    return QuantConfig(fmt=fmt)


def main(argv: list[str] | None = None) -> dict[str, TrainResult]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train", description=__doc__)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--fmt", nargs="+", default=list(DEFAULT_FMTS),
                    help="quantized <E,M> formats to train beside fp32, as E,M")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    variants: list[tuple[str, QuantConfig | None]] = [("fp32", None)]
    for s in args.fmt:
        fmt = parse_fmt(s)
        variants.append((f"mls{fmt}", preset(fmt)))
    results = {}
    for name, qcfg in variants:
        print(f"== training {name} ==")
        results[name] = train_variant(name, qcfg, args.steps, args.width, args.hw,
                                      args.batch, device=args.device)
    print("\n== summary ==")
    for name, r in results.items():
        k = max(len(r.accs) // 5, 1)
        later = r.step_s[1:] or r.step_s
        print(f"  {name:10s} final loss={r.losses[-1]:.4f} acc(avg last {k})="
              f"{sum(r.accs[-k:]) / k:.3f} median step after step 1="
              f"{statistics.median(later) * 1e3:.1f} ms")
    return results
