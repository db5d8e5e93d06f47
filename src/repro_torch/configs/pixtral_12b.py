"""pixtral-12b — pixtral-ViT frontend (STUB: input_specs feeds precomputed
patch embeddings) + mistral-nemo-style decoder backbone.
[hf:mistralai/Pixtral-12B-2409; unverified]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="pixtral-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, rope_theta=1e9,
    frontend="vision", frontend_dim=1024, frontend_len=256,
)
