"""Device meshes of the launchers.

The port of the JAX package's ``launch/mesh.py``.  Each mesh is made by a
FUNCTION, so importing this module touches no device or process-group
state.  A mesh is a ``torch.distributed`` ``DeviceMesh`` over the ranks of
the running world (started by ``torchrun``, or
``init_process_group``), one device a rank.

Single pod: 16 x 16 = 256 devices, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 devices, axes ("pod", "data", "model"); the
leading ``pod`` axis is pure data parallelism (see
:mod:`repro_torch.parallel.specs`).
"""
from __future__ import annotations

import math

__all__ = ["PRODUCTION_SHAPES", "make_local_mesh", "make_mesh", "make_production_mesh"]

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_mesh(shape, axes, device_type: str | None = None):
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    world's ranks (``device_type``: "cuda" when a GPU is present, else
    "cpu").  Raises, naming the shortfall, when the world is smaller than
    the mesh."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in length")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world < need:
        raise RuntimeError(f"a {'x'.join(map(str, shape))} mesh {axes} needs {need} ranks; "
                           f"the world has {world} ({need - world} short)")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The JAX package's production mesh: (16, 16) or, multi-pod, (2, 16, 16)."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return make_mesh(shape, axes, device_type)


def make_local_mesh(data: int = 1, model: int = 1, device_type: str | None = None):
    """A small ("data", "model") mesh over the running world (tests, examples)."""
    return make_mesh((data, model), ("data", "model"), device_type)
