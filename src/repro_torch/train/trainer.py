"""Train and serve steps for the LM families: loss -> grads ->
clip -> optimizer, with microbatch gradient accumulation and a
deterministic per-step rounding key.

The port of the JAX package's ``train/trainer.py``.  A step takes the
model (an :class:`~repro_torch.models.lm.LM`, whose parameters it updates
in place: the JAX step returns new arrays), the :class:`OptState` and a
batch, and returns ``(model, opt_state, metrics)``.  The step's key is
``fold_in(run.seed, step)``; :func:`~repro_torch.models.lm.lm_loss` rounds
every quantized GEMM operand stochastically from it.  With ``microbatch =
n > 1`` the batch is split into n parts along its first axis, each part's
gradients are added up in fp32 under the **same** key, and the sums of
gradients and losses are divided by n.  The MLS-compressed cross-pod
gradient exchange (``run.grad_compression``) belongs to the multi-pod
launcher, which waits for ``parallel`` (ROADMAP queue 1): on one card the
flag changes nothing, as on one pod in the JAX package.
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import fold_in
from repro_torch.models import lm
from repro_torch.optim import OptState, clip_by_global_norm, cosine_schedule, make_optimizer

__all__ = ["make_prefill_step", "make_serve_step", "make_train_step"]


def make_train_step(run: RunConfig, lr_fn: Callable | None = None):
    """``(train_step, opt_init)`` for ``run``: ``opt_init(model)`` gives the
    optimizer's state at step 0, ``train_step(model, opt_state, batch)``
    takes one step and returns ``(model, opt_state, {"loss", "grad_norm",
    "lr", "aux"})`` (0-dim fp32 tensors; ``aux`` is the MoE layers'
    load-balance loss inside ``loss``, 0 for the other families, averaged
    over the microbatches as the loss is).  The batch holds whatever
    ``lm_loss`` reads (``tokens``, and ``frontend_emb`` or the
    encoder-decoder's ``src_emb``), each split along its first axis.
    ``lr_fn(step)`` defaults to a cosine of ``run.lr`` with 100 warmup
    steps over 10,000."""
    cfg = run.model
    opt_init, opt_update = make_optimizer(run.optimizer, weight_decay=run.weight_decay)
    lr_fn = lr_fn or cosine_schedule(run.lr, warmup=100, total=10_000)

    def train_step(model: lm.LM, opt_state: OptState, batch: dict):
        _check_model(model, cfg)
        step = opt_state.step
        key = fold_in(run.seed, step)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        n = run.microbatch if run.microbatch and run.microbatch > 1 else 1
        if any(v.shape[0] % n for v in batch.values()):
            raise ValueError(f"microbatch {n} does not divide the batch "
                             f"{[tuple(v.shape) for v in batch.values()]}")
        parts = [{k: v.chunk(n, dim=0)[i] for k, v in batch.items()} for i in range(n)]
        loss = aux = None
        for part in parts:  # each part's gradients add into .grad, in fp32
            part_loss, part_metrics = lm.lm_loss(model, part, key)
            part_loss.backward()
            part_loss = part_loss.detach().float()
            part_aux = part_metrics["aux"].detach().float()
            loss = part_loss if loss is None else loss + part_loss
            aux = part_aux if aux is None else aux + part_aux
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for k, p in params.items()}
        if n > 1:
            grads = {k: g.div_(n) for k, g in grads.items()}
            loss, aux = loss / n, aux / n
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip)
        lr = lr_fn(step)
        opt_state = opt_update(grads, opt_state, params, lr)
        for p in params.values():
            p.grad = None
        return model, opt_state, {"loss": loss, "grad_norm": gnorm,
                                  "lr": torch.as_tensor(lr, dtype=torch.float32), "aux": aux}

    return train_step, opt_init


def _check_model(model: lm.LM, cfg: ModelConfig) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the model was built for {model.cfg.name}, not the step's {cfg.name}")


def make_serve_step(cfg: ModelConfig):
    """``serve_step(model, cache, tokens (B, 1)) -> (logits (B, vocab),
    cache)``: :func:`~repro_torch.models.lm.decode_step` of a model built
    for ``cfg`` (another model raises ``ValueError``)."""

    def serve_step(model: lm.LM, cache: dict, tokens: torch.Tensor):
        _check_model(model, cfg)
        return lm.decode_step(model, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """``prefill_step(model, batch) -> (logits of the last position,
    cache)``: :func:`~repro_torch.models.lm.prefill` into a cache of
    ``max_len`` positions, of a model built for ``cfg`` (another model
    raises ``ValueError``)."""

    def prefill_step(model: lm.LM, batch: dict):
        _check_model(model, cfg)
        return lm.prefill(model, batch, max_len)

    return prefill_step
