"""Transformer components of the LM families: GQA attention (full or half
rotary, optional QKV bias, sliding window, KV cache) and the gated MLP,
every GEMM optionally on the paper's MLS low-bit path (with
``qcfg.backend == "quantized"``, K1 on both operands and K3).

The port of the JAX package's ``models/transformer.py``, as ``nn.Module``s
whose parameter names are the JAX pytree's (``attn.wq.w``, ``mlp.w_up.w``,
``ln1.gamma``).  Each quantized linear derives its rounding stream from its
own site tag, as in JAX: 0-3 for the attention projections, 10-12 for the
MLP.  Dtypes follow the JAX package: the linears return fp32, rotary
embeddings and attention run in fp32, the KV cache holds the compute dtype,
and each residual add is in the input's dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import QuantConfig, fold_in

from . import nn as L

__all__ = ["MLP", "Attention", "Block", "LayerNorm", "RMSNorm", "norm_init"]


class RMSNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d))

    def forward(self, x):
        return L.rmsnorm(x, self.gamma)


class LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(d))
        self.beta = nn.Parameter(torch.zeros(d))

    def forward(self, x):
        return L.layernorm(x, self.gamma, self.beta)


def norm_init(cfg: ModelConfig) -> nn.Module:
    """The config's norm (``cfg.norm``) over ``d_model``."""
    return RMSNorm(cfg.d_model) if cfg.norm == "rmsnorm" else LayerNorm(cfg.d_model)


class Attention(nn.Module):
    """Grouped-query attention: ``wq``, ``wk``, ``wv`` (with the config's
    QKV bias) and ``wo``; causal self-attention unless told otherwise, or
    cross-attention over a source sequence or its precomputed K/V."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.d_model, cfg.hd
        self.wq = L.Linear(d, cfg.n_heads * hd, cfg.qkv_bias)
        self.wk = L.Linear(d, cfg.n_kv_heads * hd, cfg.qkv_bias)
        self.wv = L.Linear(d, cfg.n_kv_heads * hd, cfg.qkv_bias)
        self.wo = L.Linear(cfg.n_heads * hd, d)

    def init_(self, generator: torch.Generator) -> None:
        for lin in (self.wq, self.wk, self.wv, self.wo):
            lin.init_(generator, std=0.02)

    def forward(
        self,
        x: torch.Tensor,  # (B, S, d)
        qcfg: QuantConfig | None,
        key: int | None,
        *,
        positions: torch.Tensor | None = None,  # (B, S) absolute positions of x
        cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # (B, M, KV, hd) x2
        cache_pos: int = 0,  # write offset into the cache
        kv_valid: int | None = None,  # valid cache slots (ring buffers)
        window: int | None = None,
        causal: bool = True,
        kv: torch.Tensor | None = None,  # cross-attention source (B, Sk, d)
        cross_cache: tuple[torch.Tensor, torch.Tensor] | None = None,  # read-only K/V
    ) -> torch.Tensor:
        """fp32 (B, S, d).  The cache is written in place at ``cache_pos``:
        where ``cache_pos + S`` passes its end this raises (the JAX
        package's ``dynamic_update_slice`` would clamp the start and
        overwrite the last slots).  Cross-attention (``kv`` or
        ``cross_cache``) has no rotary embedding and no mask;
        ``cross_cache`` (B, Sk, KV, hd) x2 is read, never written."""
        cfg = self.cfg
        b, s, _ = x.shape
        hd = cfg.hd
        q = self.wq(x, qcfg, fold_in(key, 0)).reshape(b, s, cfg.n_heads, hd)
        q_chunk = 1024 if s > 4096 else None
        if cross_cache is not None:
            out = L.gqa_attention(q, *cross_cache, causal=False, q_chunk=q_chunk)
            out = out.reshape(b, s, cfg.n_heads * hd).to(x.dtype)
            return self.wo(out, qcfg, fold_in(key, 3))
        xkv = x if kv is None else kv
        sk = xkv.shape[1]
        k = self.wk(xkv, qcfg, fold_in(key, 1)).reshape(b, sk, cfg.n_kv_heads, hd)
        v = self.wv(xkv, qcfg, fold_in(key, 2)).reshape(b, sk, cfg.n_kv_heads, hd)

        if kv is None and cfg.rotary_pct > 0:
            rd = int(hd * cfg.rotary_pct)
            if positions is None:  # absolute positions (decode: offset by the cache)
                positions = (torch.arange(s, device=x.device) + cache_pos)[None, :].expand(b, s)
            sin, cos = L.rope_angles(positions, hd, cfg.rope_theta, rd)
            q = L.apply_rope(q, sin, cos, rd)
            k = L.apply_rope(k, sin, cos, rd)

        if cache is not None:
            ck, cv = cache
            if cache_pos + s > ck.shape[1]:
                raise ValueError(f"KV cache overflow: writing {s} position(s) at {cache_pos} "
                                 f"into a cache of {ck.shape[1]} slots")
            ck[:, cache_pos:cache_pos + s] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + s] = v.to(cv.dtype)
            if kv_valid is not None:
                # ring buffer: slot order is arbitrary; rope carries positions
                out = L.gqa_attention(q, ck, cv, causal=False, kv_len=kv_valid, q_chunk=q_chunk)
            else:
                out = L.gqa_attention(q, ck, cv, causal=causal, q_offset=cache_pos,
                                      window=window, kv_len=cache_pos + s, q_chunk=q_chunk)
        else:
            out = L.gqa_attention(q, k, v, causal=causal and kv is None, window=window,
                                  q_chunk=q_chunk)

        out = out.reshape(b, s, cfg.n_heads * hd).to(x.dtype)
        return self.wo(out, qcfg, fold_in(key, 3))


class MLP(nn.Module):
    """``w_up``, ``w_down`` and, gated (SwiGLU), ``w_gate``; else GELU
    (tanh approximation, JAX's default)."""

    def __init__(self, cfg: ModelConfig, d_ff: int | None = None):
        super().__init__()
        self.gated = cfg.gated_mlp
        d, f = cfg.d_model, d_ff or cfg.d_ff
        self.w_up = L.Linear(d, f)
        self.w_down = L.Linear(f, d)
        self.w_gate = L.Linear(d, f) if cfg.gated_mlp else None

    def init_(self, generator: torch.Generator) -> None:
        for lin in (self.w_up, self.w_down, self.w_gate):
            if lin is not None:
                lin.init_(generator, std=0.02)

    def forward(self, x, qcfg: QuantConfig | None, key: int | None) -> torch.Tensor:
        up = self.w_up(x, qcfg, fold_in(key, 10))
        if self.gated:
            h = F.silu(self.w_gate(x, qcfg, fold_in(key, 11))) * up
        else:
            h = F.gelu(up, approximate="tanh")
        return self.w_down(h.to(x.dtype), qcfg, fold_in(key, 12))


class Block(nn.Module):
    """Pre-norm decoder block: ``ln1``, ``attn``, ``ln2``, ``mlp``;
    bidirectional with ``causal=False`` (the encoder's)."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.ln1 = norm_init(cfg)
        self.attn = Attention(cfg)
        self.ln2 = norm_init(cfg)
        self.mlp = MLP(cfg)

    def init_(self, generator: torch.Generator) -> None:
        self.attn.init_(generator)
        self.mlp.init_(generator)

    def forward(self, x, qcfg: QuantConfig | None, key: int | None, *, positions=None,
                cache=None, cache_pos: int = 0, kv_valid=None, window=None, causal=True):
        h = self.attn(self.ln1(x), qcfg, key, positions=positions, cache=cache,
                      cache_pos=cache_pos, kv_valid=kv_valid, window=window, causal=causal)
        x = x + h.to(x.dtype)
        h = self.mlp(self.ln2(x), qcfg, key)
        return x + h.to(x.dtype)
