"""Batched serving engine: prefill + incremental decode over a KV/SSM cache.

The port of the JAX package's ``serve/engine.py``.  Inference rounds to
nearest (no stochastic-rounding key), per :func:`repro_torch.models.lm.
decode_step`.  Sampling is greedy (argmax) or, given a ``torch.Generator``,
at a temperature; the JAX engine's ``categorical(fold_in(key, i))`` stream
cannot be reproduced, so sampled tokens differ from its tokens.

A tensor-parallel model (``parallel.tensor.tensor_parallel``, or
``launch.train.shard_model``) is served as it is placed: every rank runs
the engine on its part, and every rank's logits are the whole
vocabulary's, equal on every rank, so greedy decoding gives the same
tokens on every rank; sampling at a temperature does where every rank
seeds its generator alike.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import lm
from repro_torch.runtime import resolve_device

__all__ = ["ServeEngine"]


@dataclasses.dataclass
class ServeEngine:
    """Serves ``model`` (an :class:`~repro_torch.models.lm.LM` of ``cfg``)
    on ``device``, CUDA unless the caller asks for the CPU; the model is
    moved there, unless it is tensor-parallel or sharded by FSDP2: then it
    stays where it was placed and ``device`` is its own."""

    cfg: ModelConfig
    model: lm.LM
    max_len: int = 4096
    device: str | torch.device = "cuda"

    def __post_init__(self):
        if self.model.cfg != self.cfg:
            raise ValueError(f"the model was built for {self.model.cfg.name}, not "
                             f"{self.cfg.name} as configured")
        from torch.distributed.fsdp import FSDPModule

        if self.model.tp is not None or isinstance(self.model, FSDPModule):
            self.device = next(self.model.parameters()).device
        else:
            self.device = resolve_device(self.device)
            self.model = self.model.to(self.device)

    def prefill(self, batch: dict) -> tuple[torch.Tensor, dict]:
        """``(last-position logits (B, vocab), cache)`` of the prompts."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        return lm.prefill(self.model, batch, self.max_len)

    def decode(self, cache: dict, tokens: torch.Tensor) -> tuple[torch.Tensor, dict]:
        """One decode step of ``tokens`` (B, 1)."""
        return lm.decode_step(self.model, cache, tokens)

    @torch.inference_mode()
    def generate(
        self,
        batch: dict,  # {"tokens": (B, S_prompt), ...}
        max_new_tokens: int,
        temperature: float = 0.0,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        """Generated token ids (B, max_new_tokens): one prefill, then
        ``max_new_tokens - 1`` decode steps.  Greedy (argmax) at
        ``temperature <= 0``; above it, sampled with ``generator``, which
        must then be given."""
        if temperature > 0.0 and generator is None:
            raise ValueError("sampling at temperature > 0 needs a torch.Generator")
        logits, cache = self.prefill(batch)
        tok = self._sample(logits, temperature, generator)
        toks = [tok]
        for _ in range(1, max_new_tokens):
            logits, cache = self.decode(cache, tok)
            tok = self._sample(logits, temperature, generator)
            toks.append(tok)
        return torch.cat(toks, dim=1)

    @staticmethod
    def _sample(logits: torch.Tensor, temperature: float,
                generator: torch.Generator | None) -> torch.Tensor:
        if temperature <= 0.0:
            return torch.argmax(logits, dim=-1)[:, None]
        probs = torch.softmax(logits / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)
