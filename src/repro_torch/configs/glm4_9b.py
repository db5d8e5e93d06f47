"""glm4-9b — dense, GQA kv=2, half-rotary RoPE, QKV bias.
[hf:THUDM/glm-4-9b; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, qkv_bias=True, rotary_pct=0.5,
)
