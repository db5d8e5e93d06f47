"""MLS-compressed cross-pod gradient all-reduce: the paper's format used as
a distributed-training compressor.

The port of the JAX package's ``parallel/compress.py``.  Each pod quantizes
its pod-local gradient to packed MLS codes (1 byte an element, one <8,1>
scale per 128-element row and one fp32 tensor scale: about 4x fewer wire
bytes than fp32), passes them around a ring of p pods over
``torch.distributed``, decodes and averages.  Stochastic rounding (given
as the rounding bytes ``r_u8``) keeps the compression unbiased.

:func:`compress` runs K1 (:func:`repro_torch.kernels.mls_quantize`,
grouping "nc", ``k_block = block``) on the rows ``(n, block)`` of the
flattened, zero-padded gradient: JAX's ``GroupSpec((1, block))``, one scale
a row.  On the CPU K1's plain version runs.  Without ``r_u8`` it rounds to
nearest with no offset (``exact_nearest``), as the JAX package's
``core.mls_quantize`` without a key does.

The JAX trainer only tags ``RunConfig.grad_compression`` and never calls
the ring; the port's trainer does the same.
"""
from __future__ import annotations

import collections
import math

import torch
import torch.distributed as dist

from repro_torch.core.formats import FMT_IMAGENET, GS_FMT_DEFAULT, EMFormat
from repro_torch.core.quantize import unpack_elements

__all__ = ["WIRE", "compress", "crosspod_allreduce_mean", "decompress", "reset_wire_counts"]

# What the ring handed to isend since the last reset: bytes by dtype
# ("u8", "f32") and the number of sends.
WIRE: collections.Counter = collections.Counter()
_DTYPES = {torch.uint8: "u8", torch.float32: "f32"}


def reset_wire_counts() -> None:
    WIRE.clear()


def _flatten_pad(g: torch.Tensor, block: int) -> torch.Tensor:
    flat = g.reshape(-1).to(torch.float32)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block).contiguous()


def compress(g: torch.Tensor, fmt: EMFormat = FMT_IMAGENET, block: int = 128,
             r_u8: torch.Tensor | None = None
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> ``(codes uint8 (n, block), s_g f32 (n, 1), s_t f32 scalar)`` of
    ``g`` flattened and zero-padded to rows of ``block``.  ``r_u8`` (n,
    block) uint8 are the rounding bytes (``None``: nearest)."""
    from repro_torch.kernels import mls_quantize

    rows = _flatten_pad(g, block)
    return mls_quantize(rows, fmt, block, GS_FMT_DEFAULT, r_u8, "nc",
                        exact_nearest=r_u8 is None)


def decompress(codes: torch.Tensor, s_g: torch.Tensor, s_t: torch.Tensor, shape,
               fmt: EMFormat = FMT_IMAGENET) -> torch.Tensor:
    """The fp32 gradient of ``shape`` from :func:`compress`'s payload."""
    sign, mag = unpack_elements(codes, fmt)
    vals = sign * mag * s_g * s_t
    return vals.reshape(-1)[: math.prod(shape)].reshape(shape)


def _exchange(payload: tuple[torch.Tensor, ...], group, send_to: int, recv_from: int
              ) -> tuple[torch.Tensor, ...]:
    """Send ``payload`` to global rank ``send_to`` and receive the same
    shapes from ``recv_from`` in one batch.  gloo moves host tensors, so a
    payload on the card is staged through the host there."""
    host = dist.get_backend(group) == "gloo"
    out = [torch.empty_like(t, device="cpu" if host else t.device) for t in payload]
    sent = [t.cpu() if host else t for t in payload]
    ops = [dist.P2POp(dist.isend, t, send_to, group) for t in sent]
    ops += [dist.P2POp(dist.irecv, t, recv_from, group) for t in out]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    for t in sent:
        WIRE[_DTYPES[t.dtype]] += t.numel() * t.element_size()
        WIRE["sends"] += 1
    return tuple(o.to(p.device) for o, p in zip(out, payload))


def crosspod_allreduce_mean(g: torch.Tensor, group=None, fmt: EMFormat = FMT_IMAGENET,
                            r_u8: torch.Tensor | None = None, block: int = 128
                            ) -> torch.Tensor:
    """The mean of ``g`` over the ranks of ``group`` (default: the world),
    each rank's gradient passed around the ring as MLS codes.

    Rank i sends to i + 1 and receives from i - 1; after hop h it holds
    rank (i - h)'s payload.  The sum is JAX's order: this rank's own ``g``
    in fp32 (not its decoded copy), then the decoded payloads of i - 1,
    i - 2, ...; then ``acc / p`` in ``g``'s dtype.  p - 1 hops of
    (codes u8, s_g f32, s_t f32): per hop ``n + 4 n / block + 4`` bytes.
    With one rank, ``g`` itself."""
    p = dist.get_world_size(group)
    if p == 1:
        return g
    i = dist.get_rank(group)
    send_to = dist.get_global_rank(group, (i + 1) % p) if group is not None else (i + 1) % p
    recv_from = dist.get_global_rank(group, (i - 1) % p) if group is not None else (i - 1) % p
    payload = compress(g, fmt, block, r_u8)
    acc = g.to(torch.float32)
    for _ in range(p - 1):
        payload = _exchange(payload, group, send_to, recv_from)
        acc = acc + decompress(*payload, g.shape, fmt)
    return (acc / p).to(g.dtype)
