"""Optimizers (fp32 state) and learning-rate schedules.

The paper keeps the weight update in full precision (Alg. 1 l.13 and
Table VI "SGD Update" rows): master weights, moments and the update
itself are fp32 whatever the low-bit format of the GEMMs.

* :func:`sgdm` -- the paper's CNN recipe, ``torch.optim.SGD(momentum=0.9,
  weight_decay=5e-4)``: that is the JAX package's ``sgdm_update`` on every
  parameter, BN included (``g += wd * p``, ``m = 0.9 * m + g``, ``p -= lr *
  m``; the first step's buffer is ``g``).
* :func:`make_optimizer` -- the LM trainer's "sgdm" and "adamw", written
  out as the JAX package's formulas over dicts of tensors and an
  :class:`OptState` (step, mu, nu) that a checkpoint holds.  Not
  ``torch.optim.AdamW`` or ``clip_grad_norm_``: their ``sqrt(v) /
  sqrt(c2)`` and ``max_norm / (norm + 1e-6)`` round differently.  The
  updates write the parameters and moments in place (the JAX package
  returns new arrays), which keeps one copy of each at full width.

Scalars that the JAX package computes in float32 (the learning rate, the
bias corrections, the clip scale) are 0-dim float32 tensors here, so they
round where JAX rounds them.
"""
from __future__ import annotations

import math
from collections.abc import Callable, Iterable, Mapping
from typing import NamedTuple

import torch

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm", "cosine_schedule",
           "make_optimizer", "set_lr", "sgdm", "sgdm_init", "sgdm_update",
           "step_decay_schedule"]

Params = Mapping[str, torch.Tensor]


class OptState(NamedTuple):
    """The optimizer's state: the step (a Python int), the first moment or
    momentum and, for AdamW, the second moment, each a dict of fp32
    tensors by parameter name (``nu`` is empty for sgdm)."""

    step: int
    mu: dict
    nu: dict


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def _named(params) -> dict[str, torch.Tensor]:
    """Parameters by name, from a module or a dict of tensors."""
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def clip_by_global_norm(grads: Params, max_norm: float,
                        reduce: Callable[[torch.Tensor], torch.Tensor] | None = None,
                        model_sharded: tuple[set, Callable] | None = None
                        ) -> tuple[dict, torch.Tensor]:
    """``(grads * min(1, max_norm / max(gn, 1e-9)), gn)`` with ``gn`` the
    fp32 norm over every gradient; the scale is applied always (to each
    gradient in place).  ``reduce``, where given, sums the squared norm of
    these (sharded) gradients over the ranks that hold the other shards.
    ``model_sharded``, ``(names, reduce_model)``: the gradients of ``names``
    are shards over a tensor-parallel group, whose squared norm
    ``reduce_model`` sums over it; the others are whole on every rank of
    that group and count once.  The fp32 squares are summed in fp64 (good
    to about 1e-16) and the norm rounded to fp32, so that it does not
    depend on how the elements lie over the ranks (FSDP2 shards a weight
    on the dim ``launch.train.fsdp_shard_dim`` picks, dim 0 or JAX's
    ``fsdp`` dim, ``parallel.fsdp_wire`` on its wire dim), which an fp32
    sum's last bit does."""
    sq = {k: torch.sum(torch.square(g.float()), dtype=torch.float64) for k, g in grads.items()}
    if model_sharded is None:
        total = _sum(list(sq.values()))
    else:
        names, reduce_model = model_sharded
        total = (reduce_model(_sum([v for k, v in sq.items() if k in names]))
                 + _sum([v for k, v in sq.items() if k not in names]))
    gn = torch.sqrt(reduce(total) if reduce is not None else total).float()
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return {k: g.mul_(scale) for k, g in grads.items()}, gn


def _sum(sq: list[torch.Tensor]) -> torch.Tensor:
    return sum(sq[1:], sq[0]) if sq else _f32(0.0)


# ---------------------------------------------------------------------------
# SGD + momentum
# ---------------------------------------------------------------------------
def sgdm(params: Iterable[torch.nn.Parameter], lr: float, momentum: float = 0.9,
         weight_decay: float = 5e-4) -> torch.optim.SGD:
    """The CNN trainer's optimizer (``torch.optim.SGD``)."""
    return torch.optim.SGD(params, lr=lr, momentum=momentum, weight_decay=weight_decay)


def sgdm_init(params) -> OptState:
    return OptState(0, {k: torch.zeros_like(p, dtype=torch.float32)
                        for k, p in _named(params).items()}, {})


@torch.no_grad()
def sgdm_update(grads: Params, state: OptState, params, lr, momentum: float = 0.9,
                weight_decay: float = 5e-4) -> OptState:
    """``g += wd * p; m = momentum * m + g; p -= lr * m``, in place."""
    lr = _f32(lr)
    for k, p in _named(params).items():
        g = grads[k].float() + weight_decay * p.float()
        m = state.mu[k].mul_(momentum).add_(g)
        p.copy_(p.float() - lr * m)
    return OptState(state.step + 1, state.mu, {})


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------
def adamw_init(params) -> OptState:
    named = _named(params)
    zeros = lambda: {k: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
                     for k, p in named.items()}
    return OptState(0, zeros(), zeros())


@torch.no_grad()
def adamw_update(grads: Params, state: OptState, params, lr, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1) -> OptState:
    """Decoupled weight decay Adam on every parameter, in place:
    ``m = b1 m + (1 - b1) g``, ``v = b2 v + (1 - b2) g^2``, ``p = p (1 - lr
    wd) - lr (m / c1) / (sqrt(v / c2) + eps)`` with ``c = 1 - b^t``."""
    t = state.step + 1
    c1 = 1.0 - _f32(b1) ** _f32(t)
    c2 = 1.0 - _f32(b2) ** _f32(t)
    lr = _f32(lr)
    decay = 1.0 - lr * weight_decay
    for k, p in _named(params).items():
        g = grads[k].float()
        m = state.mu[k].mul_(b1).add_((1 - b1) * g)
        v = state.nu[k].mul_(b2).add_((1 - b2) * torch.square(g))
        u = (m / c1) / (torch.sqrt(v / c2) + eps)
        p.copy_(p.float() * decay - lr * u)
    return OptState(t, state.mu, state.nu)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------
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


def cosine_schedule(base_lr: float, warmup: int, total: int,
                    min_frac: float = 0.1) -> Callable[[int], torch.Tensor]:
    """Linear warmup from 0 over ``warmup`` steps (lr 0 at step 0), then a
    cosine from ``base_lr`` down to ``min_frac * base_lr`` at ``total``; a
    0-dim fp32 tensor, computed in fp32 as the JAX package does."""

    def lr(step: int) -> torch.Tensor:
        step = _f32(step)
        if step < warmup:
            return base_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return base_lr * (min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog)))

    return lr


def make_optimizer(name: str, **kw) -> tuple[Callable, Callable]:
    """``(init(params) -> OptState, update(grads, state, params, lr) ->
    OptState)`` of "sgdm" or "adamw"; ``kw`` goes to the update."""
    if name == "sgdm":
        return sgdm_init, lambda g, s, p, lr: sgdm_update(g, s, p, lr, **kw)
    if name == "adamw":
        return adamw_init, lambda g, s, p, lr: adamw_update(g, s, p, lr, **kw)
    raise ValueError(f"unknown optimizer {name!r}; expected 'sgdm' or 'adamw'")


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr
