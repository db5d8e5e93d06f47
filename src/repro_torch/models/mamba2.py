"""Mamba2 block: state-space duality (SSD), chunked [arXiv:2405.21060].

The port of the JAX package's ``models/mamba2.py``.  The chunked SSD turns
the recurrence into dense contractions (intra-chunk "attention-like"
products and a small scan over chunks).  The in/out projections run
through the MLS low-bit path (site tags 0 and 1); the decay and recurrence
math stays fp32.  Prefill runs the chunked form with the largest chunk
that divides the sequence and does not exceed ``ssm_chunk`` (a prime
length gives chunk 1); decode (one token with a state) is the O(1)
recurrence.  The state is ``(conv_state (B, K-1, C), ssm_state (B, H, P,
N))``: the SSM state is fp32, and the conv state is the last ``K-1`` rows
of the conv input, which comes out of the fp32 projection.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import QuantConfig, fold_in

from . import nn as L
from .transformer import RMSNorm

__all__ = ["Mamba2Block", "ssd_chunk", "ssd_chunked"]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., q) -> (..., q, q) with ``[i, j] = sum_{j < t <= i} a[t]``,
    -inf above the diagonal (the SSD 1-semiseparable mask)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    seg = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return seg.masked_fill(~mask, -torch.inf)


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P) inputs (already dt-scaled by the caller)
    a: torch.Tensor,  # (B, S, H)    log decays (negative), already dt-scaled
    bm: torch.Tensor,  # (B, S, G, N)
    cm: torch.Tensor,  # (B, S, G, N)
    chunk: int,
    init_state: torch.Tensor | None = None,  # (B, H, P, N)
) -> tuple[torch.Tensor, torch.Tensor]:
    """``(y (B, S, H, P), final_state (B, H, P, N))``, fp32 inside."""
    b, s, h, p = x.shape
    g, n = bm.shape[2], bm.shape[3]
    if s % chunk:
        raise ValueError(f"chunk {chunk} does not divide the sequence length {s}")
    nc, q = s // chunk, chunk
    rep = h // g
    x = x.float().reshape(b, nc, q, h, p)
    a = a.float().reshape(b, nc, q, h)
    bmh = bm.float().reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)  # (b, nc, q, h, n)
    cmh = cm.float().reshape(b, nc, q, g, n).repeat_interleave(rep, dim=3)

    a_cs = torch.cumsum(a, dim=2)  # (b, nc, q, h)

    # intra-chunk (diagonal blocks): (C B^T ⊙ L) x
    lmat = torch.exp(_segsum(a.permute(0, 1, 3, 2)))  # (b, nc, h, q, q)
    cb = torch.einsum("bclhn,bcshn->bchls", cmh, bmh)
    y_diag = torch.einsum("bchls,bcshp->bclhp", cb * lmat, x)

    # chunk states: the contribution of each chunk to its final state
    decay_states = torch.exp(a_cs[:, :, -1:, :] - a_cs)  # (b, nc, q, h)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", bmh, decay_states, x)

    # inter-chunk recurrence (a short loop over the chunks)
    chunk_decay = torch.exp(a_cs[:, :, -1, :])  # (b, nc, h)
    carry = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    prev = []
    for c in range(nc):
        prev.append(carry)  # the state before chunk c
        carry = states[:, c] + chunk_decay[:, c][:, :, None, None] * carry
    prev_states = torch.stack(prev, dim=1)  # (b, nc, h, p, n)

    # off-diagonal: the carry-in state read by each position
    state_decay = torch.exp(a_cs)  # (b, nc, q, h)
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", cmh, prev_states, state_decay)
    return (y_diag + y_off).reshape(b, s, h, p), carry


def ssd_chunk(s: int, ssm_chunk: int) -> int:
    """Prefill's chunk: the largest divisor of ``s`` not above ``ssm_chunk``."""
    chunk = min(ssm_chunk, s)
    while s % chunk:
        chunk -= 1
    return chunk


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Depthwise causal conv over the sequence: x (B, S, C), w (C, K) ->
    fp32 ``(y (B, S, C), new_state (B, K-1, C))``.  A given ``state`` is
    prepended (decode); else the sequence is zero-padded in front."""
    k = w.shape[1]
    if state is not None:
        xin = torch.cat([state.to(x.dtype), x], dim=1)
    else:
        xin = F.pad(x, (0, 0, k - 1, 0))
    y = _depthwise(xin, w) + b
    return y, (xin[:, -(k - 1):, :] if k > 1 else None)


def _depthwise(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), w (C, K): causal valid conv -> fp32 (B, T-K+1, C), the
    taps added in order."""
    k = w.shape[1]
    t = x.shape[1] - k + 1
    out = torch.zeros(x.shape[:1] + (t,) + x.shape[2:], dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + x[:, i:i + t, :].float() * w[:, i]
    return out


class Mamba2Block(nn.Module):
    """Pre-norm Mamba2 block with its residual: ``ln``, ``in_proj``,
    ``conv_w``/``conv_b``, ``A_log``, ``D``, ``dt_bias``, ``out_norm``,
    ``out_proj``."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, din = cfg.d_model, cfg.d_inner
        g, n, h = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        conv_dim = din + 2 * g * n
        self.ln = RMSNorm(d)
        self.in_proj = L.Linear(d, 2 * din + 2 * g * n + h)
        self.conv_w = nn.Parameter(torch.empty(conv_dim, cfg.ssm_conv))
        self.conv_b = nn.Parameter(torch.zeros(conv_dim))
        self.A_log = nn.Parameter(torch.empty(h))
        self.D = nn.Parameter(torch.ones(h))
        self.dt_bias = nn.Parameter(torch.empty(h))
        self.out_norm = RMSNorm(din)
        self.out_proj = L.Linear(din, d)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """The JAX package's ``init_mamba2`` distributions."""
        self.in_proj.init_(generator, std=0.02)
        self.conv_w.copy_(L.trunc_normal(self.conv_w.shape, 0.2, generator, self.conv_w.device))
        self.A_log.copy_(torch.log(torch.empty_like(self.A_log).uniform_(1.0, 16.0,
                                                                         generator=generator)))
        dt = torch.empty_like(self.dt_bias).uniform_(1e-3, 0.1, generator=generator)
        self.dt_bias.copy_(torch.log(torch.exp(dt) - 1.0))
        self.out_proj.init_(generator, std=0.02)

    def forward(self, x: torch.Tensor, qcfg: QuantConfig | None, key: int | None,
                state: tuple[torch.Tensor, torch.Tensor] | None = None):
        """Full sequence (train/prefill) or stateful (decode).  Returns ``(y,
        new_state)``; ``new_state`` is None unless ``state`` was given or
        S == 1."""
        cfg = self.cfg
        b, s, _ = x.shape
        din, g, n, h = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
        zxbcdt = self.in_proj(self.ln(x), qcfg, fold_in(key, 0))
        z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * g * n, h], dim=-1)
        xbc, new_conv_state = _causal_conv(xbc, self.conv_w, self.conv_b,
                                           state[0] if state is not None else None)
        xbc = F.silu(xbc)
        xin, bm, cm = torch.split(xbc, [din, g * n, g * n], dim=-1)
        xin = xin.reshape(b, s, h, cfg.ssm_headdim)
        bm, cm = bm.reshape(b, s, g, n), cm.reshape(b, s, g, n)
        dt = dt.float() + self.dt_bias
        dt = torch.logaddexp(dt, torch.zeros_like(dt))  # softplus, (B, S, H)
        a = -torch.exp(self.A_log)  # (H,)
        xdt = xin.float() * dt[..., None]
        adt = a * dt  # (B, S, H), negative

        ssm_state = state[1] if state is not None else None
        if s == 1 and state is not None:
            # O(1) decode: state = exp(a dt) * state + B ⊗ x dt; y = C · state
            da = torch.exp(adt[:, 0])  # (B, H)
            bmh = bm[:, 0].repeat_interleave(h // g, dim=1)  # (B, H, N)
            cmh = cm[:, 0].repeat_interleave(h // g, dim=1)
            new_ssm = da[:, :, None, None] * ssm_state + torch.einsum(
                "bhn,bhp->bhpn", bmh, xdt[:, 0])
            y = torch.einsum("bhpn,bhn->bhp", new_ssm, cmh)[:, None]  # (B, 1, H, P)
        else:
            y, new_ssm = ssd_chunked(xdt, adt, bm, cm, ssd_chunk(s, cfg.ssm_chunk), ssm_state)

        y = y + self.D[:, None] * xin.float()
        y = self.out_norm(y.reshape(b, s, din) * F.silu(z.float()))
        out = self.out_proj(y.to(x.dtype), qcfg, fold_in(key, 1))
        new_state = (new_conv_state, new_ssm) if state is not None or s == 1 else None
        return x + out.to(x.dtype), new_state
