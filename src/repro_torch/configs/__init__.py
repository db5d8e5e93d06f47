"""Config registry: the 10 LM architectures (the paper's CNNs live in
``repro_torch.models.cnn``), the same values as the JAX package's.
``get_config(name)`` returns the full production config;
``get_smoke_config(name)`` a reduced same-family config for CPU smoke
tests (small widths, depths, experts and vocab)."""
from __future__ import annotations

import dataclasses

from .base import SHAPES, ModelConfig, RunConfig, ShapeConfig, torch_dtype

from . import (  # noqa: E402
    chatglm3_6b,
    glm4_9b,
    llama4_scout_17b_a16e,
    mamba2_370m,
    moonshot_v1_16b_a3b,
    pixtral_12b,
    qwen2_72b,
    seamless_m4t_medium,
    yi_34b,
    zamba2_7b,
)

ARCHS = {
    m.FULL.name: m.FULL
    for m in (
        llama4_scout_17b_a16e, moonshot_v1_16b_a3b, mamba2_370m, yi_34b,
        chatglm3_6b, qwen2_72b, glm4_9b, pixtral_12b, seamless_m4t_medium,
        zamba2_7b,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: runs one train/decode step on CPU."""
    cfg = get_config(name)
    kw = dict(
        n_layers=2, d_model=64, vocab=512,
        remat="none", compute_dtype="float32",
    )
    if cfg.n_heads:
        kw.update(n_heads=4, n_kv_heads=max(1, 4 * cfg.n_kv_heads // cfg.n_heads),
                  head_dim=16, d_ff=96)
    if cfg.family == "moe":
        kw.update(n_experts=4, top_k=min(cfg.top_k, 2), moe_d_ff=64)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_headdim=16, ssm_chunk=16)
    if cfg.family == "hybrid":
        kw.update(n_layers=5, attn_every=2)
    if cfg.family == "encdec":
        kw.update(enc_layers=2)
    if cfg.frontend != "none":
        kw.update(frontend_dim=32, frontend_len=4)
    return dataclasses.replace(cfg, **kw)


def runnable_shapes(cfg: ModelConfig):
    """Which of the 4 assigned shapes run for this arch:
    ``long_500k`` only for sub-quadratic (ssm/hybrid) families."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        names.append("long_500k")
    return [SHAPES[n] for n in names]


def shape_model_config(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Shape-dependent model tweaks (e.g. zamba2 long-context window)."""
    if shape.name == "long_500k" and cfg.family == "hybrid":
        return dataclasses.replace(cfg, window=4096)
    return cfg


__all__ = [
    "ARCHS", "SHAPES", "ModelConfig", "RunConfig", "ShapeConfig",
    "get_config", "get_smoke_config", "runnable_shapes", "shape_model_config", "torch_dtype",
]
