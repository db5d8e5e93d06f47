"""llama4-scout-17b-a16e — MoE, 16 routed experts top-1 + 1 shared expert,
early fusion (text backbone here; vision enters via frontend stubs on the
pixtral config instead).  [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, moe_d_ff=8192, vocab=202048,
    n_experts=16, top_k=1, n_shared_experts=1,
    rope_theta=5e5,
)
