"""Abstract inputs and launch-time sizing of an (arch x shape) cell.

The port of the JAX package's ``launch/specs.py``.  Its ``ShapeDtypeStruct``
stand-ins are tensors on the ``meta`` device here: shapes and dtypes, no
allocation.

* train/prefill cells feed ``tokens (global_batch, seq_len)`` (plus the
  frontend's embeddings over its first ``frontend_len`` positions; the
  encoder-decoder feeds ``src_emb (B, seq_len, frontend_dim)`` to its
  encoder and targets of the same length to its decoder);
* decode cells feed one new token against a cache of ``seq_len`` (the
  encoder-decoder's also holds a 4096-frame encoder memory).

Tokens are int64, the port's index dtype (the JAX package's are int32).
"""
from __future__ import annotations

from collections.abc import Callable

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import lm
from repro_torch.parallel.sharding import axis_sizes

__all__ = ["CARRY_BUDGET_BYTES", "SRC_LEN_DECODE", "abstract_opt_state", "abstract_params",
           "batch_specs", "cache_specs", "choose_microbatch"]

SRC_LEN_DECODE = 4096  # encoder memory length of an encoder-decoder decode cell

# The JAX package's budget for the residual-stream carry per device (its
# comment: v5e has 16 GB HBM, weights and optimizer state take the rest).
# A constant of that function, kept as written; not a measurement.
CARRY_BUDGET_BYTES = 6e9


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict[str, torch.Tensor]:
    """The batch of a cell, as meta tensors."""
    b, s = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        return {"tokens": _meta((b, 1), torch.int64)}
    out = {"tokens": _meta((b, s), torch.int64)}
    if cfg.family == "encdec":
        out["src_emb"] = _meta((b, s, cfg.frontend_dim), torch.float32)
    elif cfg.frontend != "none":
        out["frontend_emb"] = _meta((b, cfg.frontend_len, cfg.frontend_dim), torch.float32)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """The decode cache of a decode cell, as meta tensors, and ``pos`` 0."""
    if shape.kind != "decode":
        raise ValueError(f"{shape.name} is a {shape.kind} cell: only decode cells hold a cache")
    spec = lm.cache_spec(cfg, shape.global_batch, shape.seq_len, src_len=SRC_LEN_DECODE)
    cache: dict = {name: _meta(s, dt) for name, (s, dt) in spec.items()}
    cache["pos"] = 0
    return cache


def abstract_params(cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """The model's parameters by name, as meta tensors."""
    with torch.device("meta"):
        return dict(lm.LM(cfg).state_dict())


def abstract_opt_state(params, opt_init: Callable):
    """``opt_init``'s state for meta ``params``: meta tensors too."""
    return opt_init(params)


def choose_microbatch(cfg: ModelConfig, shape: ShapeConfig, mesh,
                      seq_shard: bool = False) -> int:
    """Gradient-accumulation factor that keeps the per-device carry under
    :data:`CARRY_BUDGET_BYTES` (0: no accumulation).

    carry bytes = B_local * seq * d_model * 2 B * n_layers (bf16, one saved
    carry per layer under full remat), ``B_local = global_batch // dp``
    with dp the mesh's ``data`` x ``pod`` size; under sequence parallelism
    the carry is also divided by the ``model`` size.  ``mesh``: a
    ``DeviceMesh`` or a :class:`~repro_torch.parallel.MeshShape`."""
    if shape.kind != "train":
        return 0
    sizes = axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    b_local = max(1, shape.global_batch // dp)
    layers = cfg.n_layers + (cfg.enc_layers or 0)
    carry = b_local * shape.seq_len * cfg.d_model * 2 * layers
    if seq_shard:
        carry /= sizes.get("model", 1)
    n = 1
    while carry / n > CARRY_BUDGET_BYTES and n < b_local:
        n *= 2
    return n if n > 1 else 0
