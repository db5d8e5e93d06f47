"""Launch-time sizing of a training cell.

The port of the JAX package's ``launch/specs.py`` :func:`choose_microbatch`
alone: the rest of that module (abstract inputs, parameter and optimizer
specs for the multi-pod dry-run) waits for the port of ``parallel``
(ROADMAP queue 1).  In place of the JAX mesh it takes the data-parallel
size (1 on one card).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, ShapeConfig

__all__ = ["CARRY_BUDGET_BYTES", "choose_microbatch"]

# The JAX package's budget for the residual-stream carry per device (its
# comment: v5e has 16 GB HBM, weights and optimizer state take the rest).
# A constant of that function, kept as written; not a measurement.
CARRY_BUDGET_BYTES = 6e9


def choose_microbatch(cfg: ModelConfig, shape: ShapeConfig, dp: int = 1) -> int:
    """Gradient-accumulation factor that keeps the per-device carry under
    :data:`CARRY_BUDGET_BYTES` (0: no accumulation).

    carry bytes = B_local * seq * d_model * 2 B * n_layers (bf16, one saved
    carry per layer under full remat), ``B_local = global_batch // dp``."""
    if shape.kind != "train":
        return 0
    b_local = max(1, shape.global_batch // dp)
    layers = cfg.n_layers + (cfg.enc_layers or 0)
    carry = b_local * shape.seq_len * cfg.d_model * 2 * layers
    n = 1
    while carry / n > CARRY_BUDGET_BYTES and n < b_local:
        n *= 2
    return n if n > 1 else 0
