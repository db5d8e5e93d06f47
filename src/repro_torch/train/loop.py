"""Train a CNN of the zoo on synthetic CIFAR-like data with the MLS low-bit
training framework, beside the fp32 baseline (the paper's own experiment
at a chosen scale; the port's counterpart of
``examples/train_cifar_lowbit.py``).

A run's state (:class:`TrainState`) is the model, the momentum buffers,
the data stream's position and the step; :meth:`TrainState.state_dict`
holds all of it with the step's rounding key, so a run restored from a
:class:`~repro_torch.train.checkpoint.CheckpointManager` checkpoint
repeats the uninterrupted run bit for bit.
"""
from __future__ import annotations

import argparse
import dataclasses
import statistics

import torch
import torch.nn.functional as F

from repro_torch.core.formats import EMFormat
from repro_torch.core.lowbit import BACKENDS, QuantConfig, fold_in
from repro_torch.data.synthetic import CifarIterator
from repro_torch.kernels import launch_counts
from repro_torch.models.cnn import ARCHS, CNN, CNNConfig, init_cnn
from repro_torch.optim.optimizers import set_lr, sgdm, step_decay_schedule
from repro_torch.runtime import resolve_device

from .checkpoint import CheckpointManager
from .straggler import StragglerMonitor

__all__ = ["DEFAULT_FMTS", "TrainResult", "TrainState", "init_state", "main", "parse_fmt",
           "preset", "train_step", "train_variant"]

_ROUNDING_SEED = 7  # as examples/train_cifar_lowbit.py: fold_in(key(7), step)
DEFAULT_FMTS = ("2,4", "2,1")  # the paper's <2,4> and <2,1>, beside fp32
BASE_LR = 0.05
CKPT_EVERY = 50  # steps between checkpoints, as examples/train_cifar_lowbit.py


@dataclasses.dataclass
class TrainResult:
    name: str
    losses: list[float] = dataclasses.field(default_factory=list)
    accs: list[float] = dataclasses.field(default_factory=list)
    step_s: list[float] = dataclasses.field(default_factory=list)
    # CUDA kernel launches of each step, by kernel
    launches: list[dict[str, int]] = dataclasses.field(default_factory=list)
    straggler: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TrainState:
    """What a training run carries from one step to the next."""

    model: CNN
    opt: torch.optim.Optimizer
    data: CifarIterator
    step: int = 0

    def state_dict(self) -> dict:
        """The checkpointed state: parameters, momentum buffers (``None``
        before the first step), the data stream's step, the step and its
        stochastic-rounding key."""
        params = list(self.model.parameters())
        return {"model": self.model.state_dict(),
                "momentum": [self.opt.state[p].get("momentum_buffer") for p in params],
                "data_step": self.data.step, "step": self.step,
                "rounding_key": fold_in(_ROUNDING_SEED, self.step)}

    def load_state_dict(self, sd: dict) -> None:
        if sd["rounding_key"] != fold_in(_ROUNDING_SEED, sd["step"]):
            raise ValueError("checkpoint's rounding key does not belong to its step")
        self.model.load_state_dict(sd["model"])
        for p, buf in zip(self.model.parameters(), sd["momentum"]):
            if buf is not None:
                self.opt.state[p]["momentum_buffer"] = buf.to(p.device).clone()
        self.data.step, self.step = sd["data_step"], sd["step"]


def init_state(cfg: CNNConfig, batch: int, seed: int = 0,
               device: str | torch.device = "cuda") -> TrainState:
    """A fresh run: weights from ``seed``, SGD with momentum, the data
    stream of ``seed`` at step 0."""
    device = resolve_device(device)
    model = init_cnn(cfg, seed, device)
    data = CifarIterator(batch, cfg.in_hw, cfg.num_classes, seed=seed, device=device)
    return TrainState(model, sgdm(model.parameters(), lr=BASE_LR), data)


def train_step(state: TrainState, qcfg: QuantConfig | None, lr: float) -> tuple[float, float]:
    """One SGD step on the next batch; returns (loss, accuracy), read back
    from the device (so the step has finished)."""
    b = next(state.data)
    set_lr(state.opt, lr)
    logits = state.model(b["image"], qcfg, fold_in(_ROUNDING_SEED, state.step))
    loss = F.cross_entropy(logits, b["label"])
    state.opt.zero_grad(set_to_none=True)
    loss.backward()
    state.opt.step()
    state.step += 1
    acc = (logits.argmax(-1) == b["label"]).float().mean()
    return float(loss.detach()), float(acc)


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
    arch: str = "resnet20",
    num_classes: int = 10,
    ckpt: CheckpointManager | None = None,
    log_every: int = 1,
) -> TrainResult:
    """Train a fresh model (weights from ``seed``) for ``steps`` SGD steps;
    ``qcfg`` None is the fp32 baseline.  With ``ckpt``, the state is saved
    every ``CKPT_EVERY`` steps without blocking.  Every ``log_every``-th
    step is logged.  Runs on CUDA unless ``device="cpu"``."""
    state = init_state(CNNConfig(arch, num_classes, width, hw), batch, seed, device)
    lr_fn = step_decay_schedule(BASE_LR, [steps // 2, 3 * steps // 4])
    mon = StragglerMonitor()
    res = TrainResult(name)
    for i in range(steps):
        before = launch_counts()
        mon.start()
        loss_v, acc_v = train_step(state, qcfg, lr_fn(i))
        res.step_s.append(mon.stop())
        res.losses.append(loss_v)
        res.accs.append(acc_v)
        res.launches.append({k: v - before[k] for k, v in launch_counts().items()})
        if ckpt is not None and state.step % CKPT_EVERY == 0:
            ckpt.save(state.step, state.state_dict(), blocking=False)
        if (i + 1) % log_every == 0:
            log(f"  [{name}] step {i + 1}: loss={loss_v:.4f} acc={acc_v:.3f} "
                f"({res.step_s[-1] * 1e3:.1f} ms)")
    if ckpt is not None:
        ckpt.wait()
    res.straggler = mon.report()
    return res


def parse_fmt(s: str) -> EMFormat:
    """``"E,M"`` -> :class:`EMFormat`."""
    e, m = (int(v) for v in s.split(","))
    return EMFormat(e, m)


def preset(fmt: EMFormat, backend: str = "quantized") -> QuantConfig:
    """The trainer's quantized variant: the paper's setting, k_block 128,
    grouping "nc", stochastic rounding."""
    return QuantConfig(fmt=fmt, backend=backend)


def main(argv: list[str] | None = None) -> dict[str, TrainResult]:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.train", description=__doc__)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="resnet20")
    ap.add_argument("--classes", type=int, default=10)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--hw", type=int, default=32)
    ap.add_argument("--width", type=float, default=1.0)
    ap.add_argument("--fmt", nargs="+", default=list(DEFAULT_FMTS),
                    help="quantized <E,M> formats to train beside fp32, as E,M")
    ap.add_argument("--backend", choices=BACKENDS, default="quantized")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    variants: list[tuple[str, QuantConfig | None]] = [("fp32", None)]
    for s in args.fmt:
        fmt = parse_fmt(s)
        variants.append((f"mls{fmt}", preset(fmt, args.backend)))
    results = {}
    for name, qcfg in variants:
        print(f"== training {args.arch} {name} ==")
        results[name] = train_variant(name, qcfg, args.steps, args.width, args.hw, args.batch,
                                      device=args.device, arch=args.arch,
                                      num_classes=args.classes)
    print("\n== summary ==")
    for name, r in results.items():
        k = max(len(r.accs) // 5, 1)
        later = r.step_s[1:] or r.step_s
        print(f"  {name:10s} final loss={r.losses[-1]:.4f} acc(avg last {k})="
              f"{sum(r.accs[-k:]) / k:.3f} median step after step 1="
              f"{statistics.median(later) * 1e3:.1f} ms")
    return results
