"""The low-bit training loops: the CNN trainer (``python -m
repro_torch.train``), the LM train and serve steps (:mod:`.trainer`), checkpoints
and straggler monitoring."""
from .checkpoint import CheckpointManager
from .straggler import StragglerMonitor
from .trainer import make_prefill_step, make_serve_step, make_train_step

__all__ = ["CheckpointManager", "StragglerMonitor", "make_prefill_step", "make_serve_step",
           "make_train_step"]
