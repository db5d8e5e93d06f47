"""Data and model parallelism of the port: logical-axis sharding rules on a
``DeviceMesh`` (:mod:`.sharding`), the parameter, batch and cache layouts
(:mod:`.specs`), the MLS-compressed cross-pod gradient ring
(:mod:`.compress`), tensor parallelism over the ``model`` axis
(:mod:`.tensor`) and FSDP's 1-byte weight gather (:mod:`.fsdp_wire`),
over ``torch.distributed``."""
from .sharding import (
    DEFAULT_RULES,
    SP_RULES,
    AxisRules,
    MeshShape,
    PartitionSpec,
    axis_rules,
    current_rules,
    logical_to_mesh,
    placements,
    shard,
    wire_pin,
)

__all__ = [
    "DEFAULT_RULES", "SP_RULES", "AxisRules", "MeshShape", "PartitionSpec", "axis_rules",
    "current_rules", "logical_to_mesh", "placements", "shard", "wire_pin",
]
