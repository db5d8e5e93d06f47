"""zamba2-7b — Mamba2 backbone + ONE shared attention+MLP block applied
every 6 layers (per-instance LoRA simplified to pure sharing).
[arXiv:2411.15242; unverified]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, attn_every=6,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_groups=1, ssm_conv=4,
    sub_quadratic=True,
)
