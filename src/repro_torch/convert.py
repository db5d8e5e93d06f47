"""Parameter conversion from the JAX package's pytrees (as numpy arrays).

A JAX CNN of the zoo is a nested dict/list of arrays; the port's models
name each parameter by its path in that tree (``blocks.3.conv1.w``,
``convs.3.conv.w``, ``inception.4.b5.conv.w``), with the same layouts
(OIHW convs, (d_in, d_out) classifier).  A JAX LM stacks its layers on a
leading axis for its layer scan; :func:`lm_params_from_jax` unstacks them
into the port's per-layer names (``layers.3.attn.wq.w``,
``enc_layers.3.mlp.w_up.w``, ``shared_attn.mlp.w_up.w``).  Takes numpy arrays, e.g.
``jax.tree.map(np.asarray, init_cnn(key, cfg))``, so this module needs no
JAX.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence

import numpy as np
import torch

__all__ = ["cnn_params_from_jax", "lm_params_from_jax", "resnet_params_from_jax"]


def _flatten(tree, prefix: str, out: dict[str, np.ndarray]) -> None:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    elif isinstance(tree, Sequence) and not isinstance(tree, (str, bytes)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}{i}.", out)
    else:
        out[prefix[:-1]] = np.asarray(tree)


def cnn_params_from_jax(tree) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX CNN pytree of numpy arrays (any
    architecture of the zoo)."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in flat.items()}


resnet_params_from_jax = cnn_params_from_jax  # the name of the ResNet-20 slice


def lm_params_from_jax(tree, cfg) -> dict[str, torch.Tensor]:
    """The port's ``state_dict`` for a JAX LM pytree of numpy arrays
    (``models.lm.init_lm``'s layout): every leaf under ``layers`` carries a
    leading axis of ``cfg.n_layers`` (under ``enc_layers``, of
    ``cfg.enc_layers``) and becomes one tensor per layer; an MoE layer's
    expert stacks (E, ...) stay whole."""
    flat: dict[str, np.ndarray] = {}
    _flatten(tree, "", flat)
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    out = {}
    for name, v in flat.items():
        v = np.array(v, dtype=np.float32)
        stack, _, rest = name.partition(".")
        if stack not in stacks:
            out[name] = torch.from_numpy(v)
            continue
        n = stacks[stack]
        if v.shape[0] != n:
            raise ValueError(f"{name}: leading axis {v.shape[0]}, expected the "
                             f"{n} stacked {stack} of {cfg.name}")
        for i in range(n):
            out[f"{stack}.{i}.{rest}"] = torch.from_numpy(v[i].copy())
    return out
