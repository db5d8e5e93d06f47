"""The paper's CNN optimizer recipe: SGD with momentum and weight decay, in
fp32, with a step-decayed learning rate.

``torch.optim.SGD(momentum=0.9, weight_decay=5e-4)`` is the JAX package's
``sgdm_update`` on every parameter, BN included: ``g += wd * p``,
``m = 0.9 * m + g`` (the first step's buffer is ``g`` = ``0.9 * 0 + g``),
``p -= lr * m``.
"""
from __future__ import annotations

from collections.abc import Callable, Iterable

import torch

__all__ = ["sgdm", "set_lr", "step_decay_schedule"]


def sgdm(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9,
         weight_decay: float = 5e-4) -> torch.optim.SGD:
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def step_decay_schedule(base_lr: float, boundaries: Iterable[int],
                        factor: float = 0.1) -> Callable[[int], float]:
    """lr/10 at each boundary (paper: epochs 80/120 on CIFAR)."""
    boundaries = tuple(boundaries)

    def lr(step: int) -> float:
        mult = 1.0
        for b in boundaries:
            if step >= b:
                mult *= factor
        return base_lr * mult

    return lr


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
