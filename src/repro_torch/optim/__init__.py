"""SGD with momentum and a step-decayed learning rate."""
from .optimizers import set_lr, sgdm, step_decay_schedule

__all__ = ["set_lr", "sgdm", "step_decay_schedule"]
