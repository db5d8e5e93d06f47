"""Launchers: the LM train launcher (``python -m repro_torch.launch.train``,
one process or HSDP under torchrun), its meshes (:mod:`.mesh`), the
abstract inputs and microbatch rule of a cell (:mod:`.specs`), the
roofline terms (:mod:`.roofline`) and the dry run of the production
meshes (``python -m repro_torch.launch.dryrun``; its counts,
:mod:`.trace_counts`)."""
from .specs import choose_microbatch

__all__ = ["choose_microbatch"]
