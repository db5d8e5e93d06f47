"""Optimizers (the CNN's SGD with momentum; the LM's AdamW and sgdm with
global-norm clipping) and learning-rate schedules."""
from .optimizers import (
    OptState,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    cosine_schedule,
    make_optimizer,
    set_lr,
    sgdm,
    sgdm_init,
    sgdm_update,
    step_decay_schedule,
)

__all__ = ["OptState", "adamw_init", "adamw_update", "clip_by_global_norm", "cosine_schedule",
           "make_optimizer", "set_lr", "sgdm", "sgdm_init", "sgdm_update",
           "step_decay_schedule"]
