"""Launch descriptors of the port's CUDA kernels.

A :class:`LaunchSpec` says what one launch of a kernel touches, in the
terms of the TPU's ``BlockSpec``s: its grid, the axes a block walks in
order inside itself (the TPU's sequential grid axes, such as K3's and K4's
walk over the scaling groups, modelled as trailing grid axes), and for
each operand the array shape, the block shape and the map from a grid
point to the block it reads or writes.  It also declares the kernel's
integer accumulations.  The static verifier
(:mod:`repro_torch.analysis.kernel_verify`) proves coverage and the
accumulator bound from it without running anything.

Each kernel module builds the spec of a launch from the arguments it
launches with.  Its tile constants come from the built library on the card
(each source exports ``<source>_constants``, so the spec describes the
binary) and from the module's own copy on the CPU.

The wrappers :func:`record` each launch's arguments, on either device:
host-side tuples, counted in :data:`RECORDED`, turned into specs by
:func:`repro_torch.kernels.recorded_specs`.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
from collections.abc import Callable
from typing import Any

from repro_torch.analysis.intervals import Accumulation

__all__ = [
    "RECORDED",
    "LaunchSpec",
    "Operand",
    "Window",
    "in_plain_version",
    "plain_version",
    "record",
    "tile_constants",
]

# (kernel, device type, *launch arguments) -> launches, since the last reset
RECORDED: collections.Counter = collections.Counter()

_plain_depth = 0
_library_constants: dict[str, dict[str, int]] = {}


@dataclasses.dataclass(frozen=True)
class Operand:
    """One tiled operand of a launch.

    ``index_map(*coords)`` takes the grid coordinates as numpy integer
    arrays that broadcast over the grid and returns the block index, one
    array (or int) per array dimension.  ``masked``: the kernel masks the
    ragged edge, so the last block may overhang the array.
    """

    name: str  # "args[i]" / "outputs[i]": position among the C entry point's inputs / outputs
    role: str
    shape: tuple[int, ...]
    block: tuple[int, ...]
    index_map: Callable[..., tuple[Any, ...]] = dataclasses.field(compare=False, repr=False)
    output: bool = False
    masked: bool = False


@dataclasses.dataclass(frozen=True)
class Window:
    """K4's patch gather, which no block index map describes: row tiles of
    ``block_m`` patches of ``geom`` (an ``implicit_conv.ConvGeom``) in
    ``k_block``-wide scaling groups, read from each tile's halo band staged
    in shared memory: ``cb = k_block / (kh*kw)`` channels x up to
    ``band_rows`` padded rows x the padded width, at most
    ``band_bytes_max`` bytes."""

    geom: Any
    k_block: int
    block_m: int
    band_rows: int
    band_bytes_max: int


@dataclasses.dataclass(frozen=True)
class LaunchSpec:
    """One kernel launch, as the verifier sees it.

    ``grid`` names each axis and its extent: the CUDA grid (and a thread
    axis where programs are smaller than a block) first, then the
    ``sequential`` trailing axes a block walks in order.  ``active(*coords)``
    is False where a program does nothing (``None``: every program works).
    ``macs`` counts the launch's multiply-accumulates in the MLS quantized
    domain (0 for the quantizers and for fp32 kernels).
    """

    kernel: str
    grid: tuple[tuple[str, int], ...]
    sequential: int
    operands: tuple[Operand, ...]
    accumulations: tuple[Accumulation, ...] = ()
    active: Callable[..., Any] | None = dataclasses.field(default=None, compare=False,
                                                          repr=False)
    window: Window | None = None
    macs: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(n for _, n in self.grid)

    def describe(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.grid)
        return f"{self.kernel}[{axes}; {self.sequential} sequential]"


def record(kernel: str, device_type: str, *args) -> None:
    """Count one launch of ``kernel`` with these launch arguments (the
    arguments of its module's spec builder)."""
    RECORDED[(kernel, device_type, *args)] += 1


@contextlib.contextmanager
def plain_version():
    """Marks a wrapper running its kernel's plain version (its tensor lies on
    the CPU): the coverage audit counts the launch from its record, not the
    PyTorch ops inside."""
    global _plain_depth
    _plain_depth += 1
    try:
        yield
    finally:
        _plain_depth -= 1


def in_plain_version() -> bool:
    return _plain_depth > 0


def tile_constants(query: str, python: dict[str, int], device_type: str) -> dict[str, int]:
    """A kernel source's tile constants: on the card read from the built
    library through ``query`` (in the order of ``python``'s keys), on the CPU
    the module's copy ``python``."""
    if device_type != "cuda":
        return dict(python)
    if query not in _library_constants:
        from . import build

        buf = (ctypes.c_int * len(python))()
        n = getattr(build.library(), query)(buf, len(python))
        if n != len(python):
            raise RuntimeError(f"{query} reports {n} constants, the descriptor knows "
                               f"{len(python)}: {list(python)}")
        _library_constants[query] = dict(zip(python, buf))
    return dict(_library_constants[query])
