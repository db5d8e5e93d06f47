"""seamless-m4t-medium — encoder-decoder, audio frontend STUB (input_specs
feeds precomputed frame embeddings).  [arXiv:2308.11596; hf]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="seamless-m4t-medium", family="encdec",
    n_layers=12, enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=256206, norm="layernorm", gated_mlp=False,
    frontend="audio", frontend_dim=512,
)
