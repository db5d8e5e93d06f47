"""The low-bit training loop (``python -m repro_torch.train``), checkpoints
and straggler monitoring."""
from .checkpoint import CheckpointManager
from .straggler import StragglerMonitor

__all__ = ["CheckpointManager", "StragglerMonitor"]
