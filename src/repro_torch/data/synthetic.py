"""Deterministic synthetic CIFAR-like data.

Class-conditional sinusoid patterns plus noise: learnable, so a CNN's
accuracy rises and quantization-induced degradation is measurable.  The
patterns are the JAX package's (``_class_pattern``); labels and noise come
from an explicit ``torch.Generator``, one per step, seeded from
``(seed, step)``, so a run is reproducible from its seed.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.lowbit import fold_in
from repro_torch.runtime import resolve_device

__all__ = ["CifarIterator", "class_pattern", "cifar_like_batch"]


def class_pattern(num_classes: int, hw: int, classes: torch.Tensor | None = None) -> torch.Tensor:
    """(classes, 3, hw, hw) fixed per-class spatial frequency patterns: of
    every class, or of the class indices ``classes`` only (the same values,
    without building the patterns of 1000 classes at 224x224 per batch)."""
    ys, xs = torch.meshgrid(torch.arange(hw), torch.arange(hw), indexing="ij")
    ys, xs = ys / hw, xs / hw  # float32
    cls = torch.arange(num_classes) if classes is None else classes
    fx = 1.0 + (cls % 5).float()
    fy = 1.0 + (cls // 5 % 5).float()
    phase = cls.float() * 0.7
    pat = torch.sin(
        2 * math.pi * (fx[:, None, None] * xs + fy[:, None, None] * ys)
        + phase[:, None, None]
    )
    return torch.stack([pat, torch.roll(pat, hw // 4, dims=-1), -pat], dim=1)


def cifar_like_batch(generator: torch.Generator, batch: int, hw: int = 32,
                     num_classes: int = 10, noise: float = 0.6,
                     device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """One batch: ``image`` f32 (batch, 3, hw, hw) and ``label`` int64, on
    CUDA unless ``device="cpu"``.  The draws are made on the host, so a
    seed gives the same batch on either device."""
    device = resolve_device(device)
    labels = torch.randint(0, num_classes, (batch,), generator=generator)
    x = class_pattern(num_classes, hw, labels)
    x = x + noise * torch.randn((batch, 3, hw, hw), generator=generator)
    return {"image": x.to(device), "label": labels.to(device)}


class CifarIterator:
    """Endless stream of batches; step ``i`` is drawn from a generator
    seeded ``fold_in(seed, i)``, so the stream resumes exactly from
    ``step``.  Batches land on CUDA unless ``device="cpu"``."""

    def __init__(self, batch: int, hw: int = 32, num_classes: int = 10, seed: int = 0,
                 device: str | torch.device = "cuda"):
        self.batch, self.hw, self.num_classes = batch, hw, num_classes
        self.seed, self.device, self.step = seed, resolve_device(device), 0

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        g = torch.Generator().manual_seed(fold_in(self.seed, self.step))
        self.step += 1
        return cifar_like_batch(g, self.batch, self.hw, self.num_classes,
                                device=self.device)
