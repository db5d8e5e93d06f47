"""moonshot-v1-16b-a3b (Moonlight) — MoE 64 experts top-6 (DeepSeek-style
fine-grained experts).  [hf:moonshotai/Moonlight-16B-A3B; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, moe_d_ff=1408, vocab=163840,
    n_experts=64, top_k=6,
    rope_theta=5e4,
)
