"""mamba2-370m — attention-free SSD (state-space duality).
[arXiv:2405.21060; unverified]"""
from .base import ModelConfig

FULL = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_groups=1, ssm_conv=4,
    tie_embeddings=True, sub_quadratic=True,
)
