"""Model / run configuration schema for the LM-family architectures.

The port's copy of the JAX package's ``configs/base.py``, with the same
fields and values.  Dtypes stay names (``"float32"``, ``"bfloat16"``);
:func:`torch_dtype` turns one into a ``torch.dtype``.  :meth:`ModelConfig.qcfg`
builds the port's :class:`~repro_torch.core.QuantConfig`, whose backend
names differ: the JAX package's ``quant_backend="pallas"`` (its
quantized-domain kernels) is the port's ``backend="quantized"`` (K1 and
K3), and ``"fake_quant"`` is ``"fake_quant"`` on both.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat, QuantConfig

__all__ = ["SHAPES", "ModelConfig", "RunConfig", "ShapeConfig", "torch_dtype"]

# ModelConfig.quant_backend -> QuantConfig.backend
_BACKENDS = {"pallas": "quantized", "fake_quant": "fake_quant"}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The ``torch.dtype`` of a config's dtype name."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int = 0
    n_kv_heads: int = 0
    d_ff: int = 0
    vocab: int = 32000
    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rotary_pct: float = 1.0  # 0.5 = half-rotary (GLM family)
    rope_theta: float = 1e4
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    gated_mlp: bool = True  # SwiGLU-style
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # expert hidden size (d_ff used for dense/shared mlp)
    n_shared_experts: int = 0
    capacity_factor: float = 1.0
    # dispatch in (seq/chunks)-long row groups (capacity is enforced per chunk)
    moe_dispatch_chunks: int = 1
    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # --- hybrid (Zamba2) ---
    attn_every: int = 0  # shared attention block every N layers (0 = off)
    # --- long-context ---
    window: int | None = None  # sliding window (long_500k mode for hybrid)
    sub_quadratic: bool = False  # True for ssm/hybrid: long_500k cell runs
    # --- enc-dec ---
    enc_layers: int = 0  # >0 -> encoder-decoder (seamless)
    # --- modality frontend stub ---
    frontend: str = "none"  # none | vision | audio
    frontend_dim: int = 0  # precomputed embedding dim of the frontend input
    frontend_len: int = 0  # number of frontend positions in the sequence
    # --- numerics ---
    quant: bool = True  # MLS low-bit training enabled (paper's technique)
    fmt: EMFormat = FMT_IMAGENET  # <2,4>: the paper's ImageNet-scale choice
    gs_fmt: EMFormat = GS_FMT_DEFAULT  # <8,1>
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # full | dots | none
    # --- perf levers of the JAX package (defaults = paper-faithful) ---
    param_gather_dtype: str = "float32"
    packed_wire: bool = False
    # Arithmetic of the quantized GEMMs: "fake_quant" (simulation) or
    # "pallas" (the quantized-domain kernels: K1 and K3 in the port).
    quant_backend: str = "fake_quant"

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def qcfg(self) -> QuantConfig | None:
        """The port's ``QuantConfig`` of every quantized linear (None when
        ``quant`` is off): "nc" groups of 128 aligned to 16 FSDP shards
        (``shard_ways=16``, which narrows a fake-quant matmul's groups where
        K / 128 is not a multiple of 16), stochastic rounding,
        ``packed_wire`` as configured, and the backend ``quant_backend``
        names ("pallas" -> "quantized")."""
        if not self.quant:
            return None
        if self.quant_backend not in _BACKENDS:
            raise ValueError(f"quant_backend must be one of {sorted(_BACKENDS)}, "
                             f"got {self.quant_backend!r}")
        return QuantConfig(fmt=self.fmt, gs_fmt=self.gs_fmt, grouping="nc", k_block=128,
                           stochastic=True, packed_wire=self.packed_wire, shard_ways=16,
                           backend=_BACKENDS[self.quant_backend])

    def n_params(self) -> int:
        """Total parameter count (for 6·N·D roofline math)."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "moe", "encdec"):
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            if self.family == "moe":
                ff = 3 * d * self.moe_d_ff * (self.n_experts + self.n_shared_experts)
                ff += d * self.n_experts  # router
            else:
                mult = 3 if self.gated_mlp else 2
                ff = mult * d * self.d_ff
            per_layer = attn + ff
            n = per_layer * self.n_layers + emb
            if self.family == "encdec":
                # decoder adds cross-attention per layer
                n += self.enc_layers * (attn + (3 if self.gated_mlp else 2) * d * self.d_ff)
                n += self.enc_layers * attn  # cross-attn in decoder layers
            return n
        if self.family == "ssm":
            per = self._ssm_params()
            return per * self.n_layers + emb
        if self.family == "hybrid":
            per = self._ssm_params()
            attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            shared = attn + 3 * d * self.d_ff
            return per * self.n_layers + shared + emb
        raise ValueError(self.family)

    def _ssm_params(self) -> int:
        d, din = self.d_model, self.d_inner
        g, n, h = self.ssm_groups, self.ssm_state, self.ssm_heads
        in_proj = d * (2 * din + 2 * g * n + h)
        conv = (din + 2 * g * n) * self.ssm_conv
        out = din * d
        return in_proj + conv + out + 3 * h  # + A_log, D, dt_bias

    def n_active_params(self) -> int:
        """Activated params per token (MoE discount) for 6·N_active·D."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        attn = d * self.hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * self.hd * d
        ff_active = 3 * d * self.moe_d_ff * (self.top_k + self.n_shared_experts)
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return (attn + ff_active + d * self.n_experts) * self.n_layers + emb


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch x input-shape) matrix."""

    name: str  # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_train(self) -> bool:
        return self.kind == "train"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training-run hyperparameters."""

    model: ModelConfig
    shape: ShapeConfig
    microbatch: int = 0  # 0 = no gradient accumulation
    optimizer: str = "adamw"
    lr: float = 3e-4
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    grad_compression: bool = False  # MLS-compressed cross-pod all-reduce
    seed: int = 0
