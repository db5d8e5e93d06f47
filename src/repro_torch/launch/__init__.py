"""Launchers: the LM train launcher (``python -m repro_torch.launch.train``)
and its microbatch rule.  The multi-pod mesh and sharding wait for the
port of ``parallel`` (ROADMAP queue 1)."""
from .specs import choose_microbatch

__all__ = ["choose_microbatch"]
