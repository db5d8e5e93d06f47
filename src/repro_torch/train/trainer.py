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
gradients and losses are divided by n.

The step runs the loss through ``model.loss`` (:func:`lm.lm_loss`), the
method the launcher registers with FSDP2 when it shards the model
(``launch.train.shard_model``).  On such a model the parameters and
gradients are DTensors: the step clips and updates this rank's shards
(:func:`local_params`), the squared norm summed over the mesh dims that
shard them, and the gradients come already averaged over the
data-parallel ranks.  Under tensor parallelism (``model.tp``) the
squares of the model-sharded gradients are summed over the model group
too, and those of the parameters every model rank holds whole count once;
AdamW updates each rank's shards.  Under sequence parallelism
(``model.seq_shard``) a rank's gradients of those whole parameters come
from its own tokens: the step sums them over the model group
(``parallel.tensor.partial_grads``, one all-reduce of them all) before the
norm, after which they are whole on every rank and count once.  On a
plain model it is the one-device step.  As in the JAX package,
``run.grad_compression`` only tags the run: the step
exchanges no compressed gradients (the ring is
:func:`repro_torch.parallel.compress.crosspod_allreduce_mean`).
"""
from __future__ import annotations

from collections.abc import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core import fold_in
from repro_torch.models import lm
from repro_torch.optim import OptState, clip_by_global_norm, cosine_schedule, make_optimizer
from repro_torch.parallel.tensor import partial_grads

__all__ = ["local_params", "make_prefill_step", "make_serve_step", "make_train_step",
           "sum_partial_grads"]


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def local_params(model: torch.nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters by name; under FSDP2, this rank's shards (views
    that an in-place update writes through)."""
    return {k: _local(p) for k, p in model.named_parameters()}


def _model_sharded(model) -> tuple[set, Callable] | None:
    """Under tensor parallelism: the names of the model-sharded parameters
    and the sum of a squared norm over the model group (None otherwise)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return None

    def reduce(sq: torch.Tensor) -> torch.Tensor:
        sq = sq.clone()
        dist.all_reduce(sq, group=tp.group)
        return sq

    return set(model.tp_layout), reduce


def sum_partial_grads(model, grads: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """``grads`` (this rank's, by name) with those a sequence-parallel model
    left partial (:func:`~repro_torch.parallel.tensor.partial_grads`)
    summed over the model group, in place, by one all-reduce of their
    concatenation (names absent from ``grads``, a frozen parameter's, are
    skipped)."""
    names = sorted(partial_grads(model) & grads.keys())
    if not names:
        return grads
    flat = torch.cat([grads[k].reshape(-1) for k in names])
    dist.all_reduce(flat, group=model.tp.group)
    at = 0
    for k in names:
        n = grads[k].numel()
        grads[k].copy_(flat[at:at + n].view_as(grads[k]))
        at += n
    return grads


def _norm_reducer(params: dict) -> Callable | None:
    """Sums a squared norm of local shards over the mesh dims that shard the
    parameters (None on a plain model)."""
    p = next((p for p in params.values() if isinstance(p, DTensor)), None)
    if p is None:
        return None
    groups = [p.device_mesh.get_group(d) for d, pl in enumerate(p.placements) if pl.is_shard()]

    def reduce(sq: torch.Tensor) -> torch.Tensor:
        for g in groups:
            dist.all_reduce(sq, group=g)
        return sq

    return reduce


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
    init, opt_update = make_optimizer(run.optimizer, weight_decay=run.weight_decay)
    lr_fn = lr_fn or cosine_schedule(run.lr, warmup=100, total=10_000)

    def opt_init(model):
        return init(local_params(model) if isinstance(model, torch.nn.Module) else model)

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
            part_loss, part_metrics = model.loss(part, key)
            part_loss.backward()
            part_loss = part_loss.detach().float()
            part_aux = part_metrics["aux"].detach().float()
            loss = part_loss if loss is None else loss + part_loss
            aux = part_aux if aux is None else aux + part_aux
        grads = {k: _local(p.grad if p.grad is not None else torch.zeros_like(p)).float()
                 for k, p in params.items()}
        grads = sum_partial_grads(model, grads)
        if n > 1:
            grads = {k: g.div_(n) for k, g in grads.items()}
            loss, aux = loss / n, aux / n
        grads, gnorm = clip_by_global_norm(grads, run.grad_clip, _norm_reducer(params),
                                           _model_sharded(model))
        lr = lr_fn(step)
        opt_state = opt_update(grads, opt_state, local_params(model), lr)
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
