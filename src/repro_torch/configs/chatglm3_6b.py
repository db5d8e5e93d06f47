"""chatglm3-6b — dense, GQA kv=2, QKV bias, half-rotary (2d) RoPE.
[arXiv:2406.12793; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="chatglm3-6b", family="dense",
    n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=65024, qkv_bias=True, rotary_pct=0.5,
)
