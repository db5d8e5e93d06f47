"""Mixture-of-Experts FFN with top-k routing and capacity-bounded dispatch.

The port of the JAX package's ``models/moe.py``.  Dispatch runs per batch
row: each row's (token, choice) slots are sorted by expert id (stably), a
slot's position in its expert's run decides whether it fits the expert's
``cap`` buffer rows, and the slots beyond it are dropped (they add zero),
GShard-style.  With ``cfg.moe_dispatch_chunks = n > 1`` (and n dividing
the sequence) each row is first split into n rows of its own.

The router runs in fp32 and is never quantized (the paper's first/last
layer reasoning, as in JAX).  The routed experts' GEMMs run the
fake-quant :func:`~repro_torch.core.lowbit.lowbit_matmul_stack` whatever
the config's backend, as the JAX package's experts call its fake-quant
``lowbit_matmul`` under ``jax.vmap``: on ``quant_backend="pallas"`` they
reach no kernel.  The shared expert is an :class:`MLP` whose linears
follow the backend (K1 and K3 on "pallas").

Each of a token's ``k`` weighted expert outputs is added in ascending
expert order starting from 0.0, the order in which the JAX package's
``.at[tok].add`` visits its sorted slots: the combine is a gather and
``k`` adds, deterministic on the card (``index_add_`` there adds with
atomics in no fixed order).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import QuantConfig, fold_in
from repro_torch.core.lowbit import lowbit_matmul_stack

from . import nn as L
from .transformer import MLP

__all__ = ["MoE", "dispatch", "positions_in_runs"]


def positions_in_runs(sorted_e: torch.Tensor) -> torch.Tensor:
    """For rows of sorted expert ids (B, T), each entry's index within its
    run of equal ids."""
    t = sorted_e.shape[1]
    idx = torch.arange(t, device=sorted_e.device).expand_as(sorted_e)
    run_start = torch.ones_like(sorted_e, dtype=torch.bool)
    run_start[:, 1:] = sorted_e[:, 1:] != sorted_e[:, :-1]
    start = torch.where(run_start, idx, torch.zeros_like(idx))
    return idx - torch.cummax(start, dim=1).values


def dispatch(topi: torch.Tensor, cap: int) -> dict[str, torch.Tensor]:
    """The dispatch of top-k choices ``topi`` (B, S, k) into buffers of
    ``cap`` rows per expert, each (B, S*k) in sorted-slot order: ``order``
    (the stable argsort of the flat choices), ``expert`` (sorted ids),
    ``pos`` (the slot's buffer row), ``token`` (its source token) and
    ``keep`` (``pos < cap``; the rest are dropped)."""
    b, s, k = topi.shape
    expert, order = torch.sort(topi.reshape(b, s * k), dim=1, stable=True)
    pos = positions_in_runs(expert)
    return dict(order=order, expert=expert, pos=pos, token=order // k, keep=pos < cap)


class MoE(nn.Module):
    """Parameters in the JAX layout: ``router`` (d -> E, no bias),
    ``w_gate`` and ``w_up`` (E, d, f), ``w_down`` (E, f, d), and ``shared``
    (an :class:`MLP` of ``moe_d_ff * n_shared_experts``) when the config
    has shared experts."""

    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
        self.router = L.Linear(d, e)
        self.w_gate = nn.Parameter(torch.empty(e, d, f))
        self.w_up = nn.Parameter(torch.empty(e, d, f))
        self.w_down = nn.Parameter(torch.empty(e, f, d))
        self.shared = (MLP(cfg, d_ff=cfg.moe_d_ff * cfg.n_shared_experts)
                       if cfg.n_shared_experts else None)

    @torch.no_grad()
    def init_(self, generator: torch.Generator) -> None:
        """``init_moe``'s distributions: the router truncated normal times
        0.02, each expert's matrices Xavier-uniform."""
        self.router.init_(generator, std=0.02)
        for w in (self.w_gate, self.w_up, self.w_down):
            lim = math.sqrt(6.0 / (w.shape[1] + w.shape[2]))
            w.uniform_(-lim, lim, generator=generator)
        if self.shared is not None:
            self.shared.init_(generator)

    def forward(self, x: torch.Tensor, qcfg: QuantConfig | None, key: int | None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x (B, S, d) -> ``(y in x's dtype, fp32 load-balance aux loss)``."""
        b, s, d = x.shape
        n = self.cfg.moe_dispatch_chunks
        if n > 1 and s % n == 0:
            y, aux = self._rows(x.reshape(b * n, s // n, d), qcfg, key)
            return y.reshape(b, s, d), aux
        return self._rows(x, qcfg, key)

    def _rows(self, x, qcfg, key):
        cfg = self.cfg
        b, s, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        cap = int(s * k / e * cfg.capacity_factor + 1)

        # routing: fp32, unquantized
        probs = torch.softmax(self.router(x.float()), dim=-1)  # (B, S, E)
        topw, topi = torch.topk(probs, k, dim=-1)
        topw = topw / topw.sum(dim=-1, keepdim=True)
        me = probs.mean(dim=(0, 1))  # the mean router probability per expert
        ce = F.one_hot(topi, e).float().sum(dim=2).mean(dim=(0, 1)) / k
        aux = e * torch.sum(me * ce)

        # dispatch into (B, E, cap, d); dropped slots go to a spare last row
        dp = dispatch(topi, cap)
        rows = torch.arange(b, device=x.device)[:, None]
        sw = torch.gather(topw.reshape(b, s * k), 1, dp["order"])
        dest = torch.where(dp["keep"], (rows * e + dp["expert"]) * cap + dp["pos"],
                           b * e * cap)
        buf = x.new_zeros(b * e * cap + 1, d).index_put(
            (dest.reshape(-1),), x[rows, dp["token"]].reshape(-1, d))
        xe = buf[:-1].reshape(b, e, cap, d).transpose(0, 1).reshape(e, b * cap, d)

        ye = self._experts(xe, qcfg, key)  # (E, B*cap, d)

        # gather back (dropped slots read 0), then each token's k outputs
        # in ascending expert order
        flat = ye.reshape(e, b, cap, d).transpose(0, 1).reshape(b * e * cap, d)
        flat = torch.cat([flat, flat.new_zeros(1, d)])
        vals = flat[dest] * sw[..., None].to(flat.dtype)  # (B, S*k, d)
        slot = torch.empty_like(dp["order"]).scatter_(
            1, dp["order"], torch.arange(s * k, device=x.device).expand(b, -1))
        slot = slot.reshape(b, s, k).sort(dim=-1).values  # a token's slots by expert
        y = torch.zeros((b, s, d), dtype=flat.dtype, device=x.device)
        for j in range(k):
            y = y + vals[rows, slot[..., j]]
        if self.shared is not None:
            y = y + self.shared(x, qcfg, fold_in(key, 9999))
        return y.to(x.dtype), aux

    def _experts(self, xe, qcfg, key):
        """The expert FFN over the stack: silu(x W_gate) * (x W_up), cast to
        the compute dtype, then W_down; the fake-quant GEMMs of site keys
        ``fold_in(key, 0/1/2)`` where quantized, else in the compute dtype."""
        wg, wu, wd = self.w_gate, self.w_up, self.w_down
        if qcfg is not None and qcfg.enabled:
            g = lowbit_matmul_stack(xe, wg, fold_in(key, 0), qcfg)
            u = lowbit_matmul_stack(xe, wu, fold_in(key, 1), qcfg)
            h = (F.silu(g) * u).to(xe.dtype)
            return lowbit_matmul_stack(h, wd, fold_in(key, 2), qcfg)
        g = torch.matmul(xe, wg.to(xe.dtype))
        u = torch.matmul(xe, wu.to(xe.dtype))
        h = (F.silu(g) * u).to(xe.dtype)
        return torch.matmul(h, wd.to(xe.dtype))
