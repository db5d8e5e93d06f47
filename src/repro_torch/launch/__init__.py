"""Launchers: the LM train launcher (``python -m repro_torch.launch.train``,
one process or HSDP under torchrun), its meshes (:mod:`.mesh`), the
abstract inputs and microbatch rule of a cell (:mod:`.specs`) and the
analytic roofline terms (:mod:`.roofline`)."""
from .specs import choose_microbatch

__all__ = ["choose_microbatch"]
