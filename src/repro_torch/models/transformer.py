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

Under tensor parallelism (``parallel.tensor.tensor_parallel``) a rank
holds its query heads (and kv heads, or all of them where they do not
split) and its slice of the MLP's hidden dim: the input passes
``copy_to_tp`` into the column-parallel ``wq``/``wk``/``wv``/``w_up``/
``w_gate``, and the row-parallel ``wo``/``w_down`` sum over the group.
Cross-attention's ``wk``/``wv`` are column-parallel over the kv heads on
``copy_to_tp(kv)`` (each rank's heads add a part of the source's
gradient), or replicated on ``kv`` where the kv heads do not split.
Where a rank's query heads do not map onto its kv heads in equal
consecutive groups (an uneven split), ``kv_map`` names the kv head each
reads.  An attention that stays replicated is not marked: it runs whole
on every rank, with no collective.  Serving, a rank's KV cache
and cross-attention cache hold only the kv heads its query heads read
(``heads[1]`` of them: the rank's split, or the ``kv_take`` slice of the
replicated ones), written after the column-parallel ``wk``/``wv`` (and
the slice).

Under sequence parallelism (``tensor_parallel(..., seq_shard=True)``) a
call's ``seq`` (a ``parallel.tensor.SeqShard``) says that ``x`` holds this
rank's tokens of the sequence, and the output does too.  A split
attention or MLP gathers ``x`` at its column-parallel entry
(``gather_seq``, in place of ``copy_to_tp``) and reduce-scatters at its
row-parallel exit (``wo``/``w_down``).  An attention kept whole runs
``wq``, ``wk``, ``wv`` and ``wo`` on the rank's tokens, gathers K and V
along the sequence and attends with its own queries (rope at their
absolute positions, the causal mask offset by the rank's first one);
replicated kv linears (uneven heads) run on the rank's tokens the same
way and are gathered before their slice.  Cross-attention reads the
encoder's output split by ``mem_seq`` (its K/V gathered) or whole
(``mem_seq`` None: the DEFAULT column-parallel entry, and a whole or
replicated ``wk``/``wv`` computed on every rank, the gradient of its K/V
summed over the group).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import QuantConfig, fold_in
from repro_torch.parallel.tensor import copy_to_tp, gather_seq

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
        # tensor parallelism (parallel.tensor.tensor_parallel): the model
        # group, this rank's query and kv heads, and [kv0, kv1) of the
        # replicated kv heads its query heads map to (None: kv heads split),
        # and the local kv head each query head reads (None: grouped)
        self.tp = None
        self.heads = (cfg.n_heads, cfg.n_kv_heads)
        self.kv_take = None
        self.kv_map = None

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
        seq=None,  # sequence parallelism: x's and the output's split (None: whole)
        mem_seq=None,  # ... and the cross-attention source's
    ) -> torch.Tensor:
        """fp32 (B, S, d).  The cache is written in place at ``cache_pos``:
        where ``cache_pos + S`` passes its end this raises (the JAX
        package's ``dynamic_update_slice`` would clamp the start and
        overwrite the last slots).  Cross-attention (``kv`` or
        ``cross_cache``) has no rotary embedding and no mask;
        ``cross_cache`` (B, Sk, KV, hd) x2 is read, never written.  Under
        sequence parallelism (``seq``) ``x`` and the output are this rank's
        tokens, ``kv`` its source frames where ``mem_seq`` is given (module
        docstring)."""
        cfg = self.cfg
        b = x.shape[0]
        hd = cfg.hd
        hq, hkv = self.heads
        own = seq is not None and self.tp is None  # a whole attention on its own queries
        xq = x
        if self.tp is not None:
            xq = copy_to_tp(x, self.tp) if seq is None else gather_seq(x, seq)
        sq = xq.shape[1]
        q = self.wq(xq, qcfg, fold_in(key, 0), wire=0, seq=seq if own else None)
        q = q.reshape(b, sq, hq, hd)
        q_chunk = 1024 if sq > 4096 else None
        if cross_cache is not None:
            out = L.gqa_attention(q, *cross_cache, causal=False, q_chunk=q_chunk,
                                  kv_map=self.kv_map)
            out = out.reshape(b, sq, hq * hd).to(x.dtype)
            return self.wo(out, qcfg, fold_in(key, 3), wire=1, seq=seq)
        k, v = self._kv(x if kv is None else kv, xq if kv is None else None, qcfg, key,
                        seq if kv is None else mem_seq, seq)
        sk = k.shape[1]
        k, v = k.reshape(b, sk, hkv, hd), v.reshape(b, sk, hkv, hd)

        q_offset = cache_pos + (seq.start if own else 0)
        if kv is None and cfg.rotary_pct > 0:
            rd = int(hd * cfg.rotary_pct)
            if positions is None:  # absolute positions (decode: offset by the cache)
                positions = (torch.arange(sk, device=x.device) + cache_pos)[None, :].expand(b, sk)
            sin, cos = L.rope_angles(positions, hd, cfg.rope_theta, rd)
            k = L.apply_rope(k, sin, cos, rd)
            if own:
                sin, cos = seq.take(sin), seq.take(cos)
            q = L.apply_rope(q, sin, cos, rd)

        if cache is not None:
            ck, cv = cache
            if cache_pos + sk > ck.shape[1]:
                raise ValueError(f"KV cache overflow: writing {sk} position(s) at {cache_pos} "
                                 f"into a cache of {ck.shape[1]} slots")
            ck[:, cache_pos:cache_pos + sk] = k.to(ck.dtype)
            cv[:, cache_pos:cache_pos + sk] = v.to(cv.dtype)
            if kv_valid is not None:
                # ring buffer: slot order is arbitrary; rope carries positions
                out = L.gqa_attention(q, ck, cv, causal=False, kv_len=kv_valid, q_chunk=q_chunk,
                                      kv_map=self.kv_map)
            else:
                out = L.gqa_attention(q, ck, cv, causal=causal, q_offset=q_offset,
                                      window=window, kv_len=cache_pos + sk, q_chunk=q_chunk,
                                      kv_map=self.kv_map)
        else:
            out = L.gqa_attention(q, k, v, causal=causal and kv is None, q_offset=q_offset,
                                  window=window, q_chunk=q_chunk, kv_map=self.kv_map)

        out = out.reshape(b, sq, hq * hd).to(x.dtype)
        return self.wo(out, qcfg, fold_in(key, 3), wire=1, seq=seq)

    def _kv(self, src, gathered, qcfg, key, src_seq, seq):
        """K and V (B, Sk, ·) of this rank's kv heads over the whole source:
        ``src`` the layer input (self-attention; ``gathered``: its whole
        sequence where a split attention gathered it) or the cross-attention
        source, ``src_seq`` its split (None: whole); ``seq`` the call's
        sequence split (None: no sequence parallelism)."""
        tp = self.tp
        if seq is not None and (tp is None or self.kv_take is not None) and src_seq is not None:
            # whole wk/wv on the rank's tokens; K/V gathered along the sequence
            k = gather_seq(self.wk(src, qcfg, fold_in(key, 1), wire=0, seq=src_seq), src_seq)
            v = gather_seq(self.wv(src, qcfg, fold_in(key, 2), wire=0, seq=src_seq), src_seq)
        else:
            if gathered is not None and self.kv_take is None:
                xkv = gathered  # split kv heads: the column-parallel entry's input
            elif tp is not None and self.kv_take is None:  # split kv heads over a cross source
                xkv = copy_to_tp(src, tp) if src_seq is None else gather_seq(src, src_seq)
            else:
                xkv = src  # replicated wk/wv over a whole input
            k = self.wk(xkv, qcfg, fold_in(key, 1), wire=0)
            v = self.wv(xkv, qcfg, fold_in(key, 2), wire=0)
            group = tp if tp is not None else (None if seq is None else seq.tp)
            if group is not None and (self.kv_take is not None or tp is None):
                # every rank's queries read these K/V: their gradients add over the group
                k, v = copy_to_tp(k, group), copy_to_tp(v, group)
        if self.kv_take is not None:
            kv0, kv1 = self.kv_take
            b, sk = k.shape[:2]
            k = k.reshape(b, sk, -1, self.cfg.hd)[:, :, kv0:kv1]
            v = v.reshape(b, sk, -1, self.cfg.hd)[:, :, kv0:kv1]
        return k, v

    def cross_kv(self, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The cross-attention K/V of the encoder's output ``memory`` (B,
        Sk, d), unquantized, (B, Sk, KV, hd) each: this rank's kv heads
        under tensor parallelism (a serving cache's ``cross_cache``)."""
        b, sk, _ = memory.shape
        hd = self.cfg.hd
        k, v = self.wk(memory), self.wv(memory)
        if self.kv_take is not None:
            kv0, kv1 = self.kv_take
            k, v = k.reshape(b, sk, -1, hd)[:, :, kv0:kv1], v.reshape(b, sk, -1, hd)[:, :, kv0:kv1]
        return k.reshape(b, sk, self.heads[1], hd), v.reshape(b, sk, self.heads[1], hd)


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
        self.tp = None

    def init_(self, generator: torch.Generator) -> None:
        for lin in (self.w_up, self.w_down, self.w_gate):
            if lin is not None:
                lin.init_(generator, std=0.02)

    def forward(self, x, qcfg: QuantConfig | None, key: int | None, seq=None) -> torch.Tensor:
        """``seq``: ``x`` and the output are this rank's tokens (sequence
        parallelism)."""
        own = None  # the rank's tokens for a whole MLP under sequence parallelism
        if self.tp is not None:
            x = copy_to_tp(x, self.tp) if seq is None else gather_seq(x, seq)
        else:
            own = seq
        up = self.w_up(x, qcfg, fold_in(key, 10), wire=0, seq=own)
        if self.gated:
            h = F.silu(self.w_gate(x, qcfg, fold_in(key, 11), wire=0, seq=own)) * up
        else:
            h = F.gelu(up, approximate="tanh")
        return self.w_down(h.to(x.dtype), qcfg, fold_in(key, 12), wire=1, seq=seq)


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
                cache=None, cache_pos: int = 0, kv_valid=None, window=None, causal=True,
                seq=None):
        h = self.attn(self.ln1(x), qcfg, key, positions=positions, cache=cache,
                      cache_pos=cache_pos, kv_valid=kv_valid, window=window, causal=causal,
                      seq=seq)
        x = x + h.to(x.dtype)
        h = self.mlp(self.ln2(x), qcfg, key, seq=seq)
        return x + h.to(x.dtype)
