"""The paper's analytical energy model (Tables V and VI, Eq. 12)."""
from .model import (
    FLOAT_ADD,
    FLOAT_MUL,
    MAC_ENERGY_PJ,
    conv_energy_ratio,
    efficiency_ratios,
    network_energy,
)

__all__ = ["FLOAT_ADD", "FLOAT_MUL", "MAC_ENERGY_PJ", "conv_energy_ratio",
           "efficiency_ratios", "network_energy"]
