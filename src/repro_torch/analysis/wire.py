"""Wire-byte budget audit of the MLS-compressed cross-pod gradient ring.

The port of the JAX package's ``analysis/wire.py``.  The JAX audit compiles
the ring and counts the collective-permute bytes of the compiled HLO; the
port has no HLO, so it runs the ring (``parallel.compress.
crosspod_allreduce_mean``) in ``n_pods`` gloo processes on the CPU and
counts the bytes each rank hands to ``isend``.  The compressed ring must
move, per hop,

    n codes (1 B) + n / block group scales (4 B) + one tensor scale (4 B)

instead of the fp32 ring's 4 n bytes: about 3.88x less for block 128.  A
regression (codes sent wider, an fp32 exchange, scales sent at full size)
shows as a collapsed ratio.  The report has the JAX audit's keys;
``n_collective_permutes`` counts the sends of one rank.
"""
from __future__ import annotations

import os
import socket
import tempfile

from repro_torch.core.formats import FMT_IMAGENET, EMFormat

__all__ = ["audit_wire_ring"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _ring_rank(rank: int, world: int, port: int, n_elems: int, fmt: EMFormat, block: int,
               out: str) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.parallel import compress

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
    try:
        g = torch.randn(n_elems, generator=torch.Generator().manual_seed(rank))
        compress.reset_wire_counts()
        compress.crosspod_allreduce_mean(g, None, fmt, block=block)
        torch.save(dict(compress.WIRE), f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def audit_wire_ring(n_elems: int = 1 << 16, n_pods: int = 2, fmt: EMFormat = FMT_IMAGENET,
                    block: int = 128) -> dict:
    """Run the compressed ring over ``n_pods`` CPU processes on a gradient of
    ``n_elems`` and report the wire bytes each one sent."""
    import torch
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "wire")
        mp.spawn(_ring_rank, args=(n_pods, _free_port(), n_elems, fmt, block, out),
                 nprocs=n_pods, join=True)
        per_rank = [torch.load(f"{out}.{r}") for r in range(n_pods)]
    if any(w != per_rank[0] for w in per_rank):
        raise RuntimeError(f"the ranks sent different payloads: {per_rank}")
    wire = per_rank[0]
    by_dtype = {k: float(v) for k, v in sorted(wire.items()) if k != "sends"}
    actual = sum(by_dtype.values())
    fp32_ring = 4.0 * n_elems * (n_pods - 1)  # the fp32 ring: p - 1 hops of 4 n bytes
    ideal = (n_elems + 4.0 * n_elems / block + 4.0) * (n_pods - 1)  # JAX's formula
    return {
        "n_elems": n_elems,
        "n_pods": n_pods,
        "fmt": str(fmt),
        "block": block,
        "wire_bytes_per_device": actual,
        "wire_bytes_by_dtype": by_dtype,
        "fp32_ring_bytes_per_device": fp32_ring,
        "ideal_compressed_bytes_per_device": ideal,
        "compression_ratio": fp32_ring / actual if actual else 0.0,
        "n_collective_permutes": int(wire.get("sends", 0)),
    }
