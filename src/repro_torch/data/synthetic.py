"""Deterministic synthetic data: CIFAR-like images and LM token streams.

* Images: class-conditional sinusoid patterns plus noise, learnable, so a
  CNN's accuracy rises and quantization-induced degradation is
  measurable.  The patterns are the JAX package's (``_class_pattern``).
* Tokens: an order-1 Markov stream, token t+1 = (t * 31 + r + 7) % vocab
  with r drawn from [0, 4): learnable by any LM, so the cross-entropy
  falls well below uniform when the model learns (the JAX package's
  ``lm_batch``).

Every draw comes from an explicit ``torch.Generator`` on the host, one per
step, seeded from ``(seed, step)``: a run is reproducible from its seed,
gives the same batch on either device, and an iterator resumes exactly
from its step (its state goes into a checkpoint).  The port's streams are
its own: the same seed draws other numbers than ``jax.random``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.lowbit import fold_in
from repro_torch.runtime import resolve_device

__all__ = ["CifarIterator", "LMIterator", "class_pattern", "cifar_like_batch", "lm_batch",
           "make_lm_iterator", "markov_tokens"]


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


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------
def markov_tokens(start: torch.Tensor, steps: torch.Tensor, vocab: int) -> torch.Tensor:
    """The stream's rule on given draws: ``start`` (B,) first tokens and
    ``steps`` (B, S-1) branch draws in [0, 4) -> int64 tokens (B, S) with
    ``tok[:, t+1] = (tok[:, t] * 31 + steps[:, t] + 7) % vocab``.

    Each step is the affine map ``x -> (a x + b) % vocab`` (a = 31, b =
    draw + 7); an inclusive scan composes the maps of steps 0..t in
    ceil(log2(S)) vectorized rounds (the JAX package scans the steps one by
    one), and token t+1 is the composed map applied to ``start``.  Every
    coefficient stays below ``vocab``, so the int64 products are exact."""
    b = steps.long() + 7
    a = torch.full_like(b, 31)
    d = 1
    while d < b.shape[1]:  # (a, b)[t] <- (a, b)[t] after (a, b)[t - d]
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        a, b = (torch.cat([a[:, :d], a[:, d:] * a_prev % vocab], dim=1),
                torch.cat([b[:, :d], (a[:, d:] * b_prev + b[:, d:]) % vocab], dim=1))
        d *= 2
    start = start.long()
    return torch.cat([start[:, None], (a * start[:, None] + b) % vocab], dim=1)


def lm_batch(generator: torch.Generator, batch: int, seq: int, vocab: int,
             device: str | torch.device = "cuda") -> dict[str, torch.Tensor]:
    """One batch ``{"tokens": int64 (batch, seq)}`` of the Markov stream,
    drawn on the host from ``generator`` and put on ``device`` (CUDA
    unless ``device="cpu"``)."""
    device = resolve_device(device)
    start = torch.randint(0, vocab, (batch,), generator=generator)
    steps = torch.randint(0, 4, (batch, seq - 1), generator=generator)
    return {"tokens": markov_tokens(start, steps, vocab).to(device)}


class LMIterator:
    """Endless stream of LM batches; step ``i`` is drawn from a generator
    seeded ``fold_in(seed, i)``.  ``extras`` ((name, shape), ...) adds
    standard normal fp32 inputs (the frontend embeddings of the vision and
    audio stubs), extra ``k`` drawn from ``fold_in(fold_in(seed, i), 100 +
    k)``.  :meth:`state_dict` (step and seed) goes into a checkpoint."""

    def __init__(self, batch: int, seq: int, vocab: int, seed: int = 0,
                 extras: tuple[tuple[str, tuple], ...] = (),
                 device: str | torch.device = "cuda"):
        self.batch, self.seq, self.vocab, self.extras = batch, seq, vocab, tuple(extras)
        self.seed, self.device, self.step = seed, resolve_device(device), 0

    def __iter__(self):
        return self

    def __next__(self) -> dict[str, torch.Tensor]:
        key = fold_in(self.seed, self.step)
        b = lm_batch(torch.Generator().manual_seed(key), self.batch, self.seq, self.vocab,
                     self.device)
        for k, (name, shape) in enumerate(self.extras):
            g = torch.Generator().manual_seed(fold_in(key, 100 + k))
            b[name] = torch.randn(shape, generator=g).to(self.device)
        self.step += 1
        return b

    def state_dict(self) -> dict[str, int]:
        return {"step": self.step, "seed": self.seed}

    def load_state_dict(self, sd: dict) -> None:
        self.step, self.seed = int(sd["step"]), int(sd["seed"])


def make_lm_iterator(batch: int, seq: int, vocab: int, seed: int = 0,
                     extras: tuple[tuple[str, tuple], ...] = (),
                     device: str | torch.device = "cuda") -> LMIterator:
    """The LM token stream at step 0 (the JAX package's
    ``make_lm_iterator``, as an iterator that carries its own state)."""
    return LMIterator(batch, seq, vocab, seed, extras, device)
