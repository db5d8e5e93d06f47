"""Roofline terms per (arch x shape x mesh): the analytic half of the JAX
package's ``launch/roofline.py``.

    compute_s    = dot_FLOPs_per_device / PEAK_FLOPS
    memory_s     = HBM_bytes_per_device / HBM_BW
    collective_s = collective_wire_bytes_per_device / LINK_BW

The model FLOPs, their expected compiled count and the HBM traffic model
are JAX's formulas.  The compute and collective byte counts come from the
caller's ``record`` (``record["hlo"]["dot_flops"]`` and ``["coll_bytes"]``),
as in JAX, where an HLO parse fills them; in the port the dry run
(:mod:`repro_torch.launch.dryrun`) fills them from a fake-tensor trace of
the step (:mod:`repro_torch.launch.trace_counts`).

Hardware constants: the NVIDIA H100 SXM5 80 GB data sheet, but for
``HBM_BYTES``, the memory a cell's peak must fit in (the dry run's
``fits``): the card's ``total_memory`` as CUDA reports it on an H100 80GB
HBM3 (the data sheet's 80 GiB less what the driver keeps; read by
``chip_smoke.py``'s dryrun phase).
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.parallel.sharding import axis_sizes

__all__ = ["HBM_BW", "HBM_BYTES", "LINK_BW", "PEAK_FLOPS", "cache_bytes_jax_layout",
           "expected_hlo_flops", "hbm_bytes", "model_flops", "roofline_terms"]

PEAK_FLOPS = 989e12  # dense bf16 tensor-core FLOP/s (H100 SXM data sheet)
HBM_BW = 3.35e12  # HBM3 bytes/s (H100 SXM data sheet)
HBM_BYTES = 85017493504  # device memory CUDA reports on an H100 80GB HBM3
LINK_BW = 450e9  # NVLink bytes/s in one direction (900 GB/s both, H100 SXM data sheet)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """MODEL_FLOPS = 6·N·D (dense) / 6·N_active·D (MoE); decode: D = B·1."""
    n = cfg.n_active_params() if cfg.family == "moe" else cfg.n_params()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch  # decode: one token per sequence


def expected_hlo_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """The compiled FLOPs to expect: model FLOPs, x 8/6 under full remat
    (the forward computed once more in the backward)."""
    mf = model_flops(cfg, shape)
    if shape.kind == "train" and cfg.remat == "full":
        return mf * 8.0 / 6.0
    return mf


def hbm_bytes(cfg: ModelConfig, shape: ShapeConfig, mesh, microbatch: int = 0,
              cache_bytes: float | None = None) -> float:
    """Per-device HBM traffic model (bytes a step), JAX's:

    train : params {2 B forward read + 2 B backward read + 4 B gradient
            write + 8 B fp32 master read/write + 8 B first moment} over the
            FSDP x TP shards, the residual carry written and read in the
            forward and again in the backward, and the logits twice;
    decode: params read (2 B) + the cache;
    prefill: params read + activations + the cache written.

    ``cache_bytes``: the device's cache (the port's rank's, as the dry run
    traced it); None: JAX's layout (:func:`cache_bytes_jax_layout`)."""
    sizes = axis_sizes(mesh)
    dp = sizes.get("data", 1) * sizes.get("pod", 1)
    param_shards = sizes.get("data", 1) * sizes.get("model", 1)  # FSDP x TP
    n = cfg.n_params()
    b_loc = max(1, shape.global_batch // dp)
    layers = cfg.n_layers + (cfg.enc_layers or 0)
    d = cfg.d_model
    if shape.kind == "train":
        params_bytes = n / param_shards * 24.0
        act = b_loc * shape.seq_len * d * 2  # one residual carry (bf16)
        act_bytes = act * layers * 4
        logits = b_loc * shape.seq_len * cfg.vocab * 4 / sizes.get("model", 1)
        return params_bytes + act_bytes + 2 * logits
    cache = cache_bytes_jax_layout(cfg, shape, mesh) if cache_bytes is None else cache_bytes
    if shape.kind == "prefill":
        params_bytes = n / param_shards * 2
        act_bytes = b_loc * shape.seq_len * d * 2 * layers * 2
        return params_bytes + act_bytes + cache
    return n / param_shards * 2 + cache


def cache_bytes_jax_layout(cfg: ModelConfig, shape: ShapeConfig, mesh) -> float:
    """The decode cache's bytes per device in JAX's layout (read once a
    step): the whole cache over every device, as ``cache_seq`` on
    ``model`` and ``batch`` on ("pod", "data") spread it (JAX's
    ``_cache_bytes``)."""
    n_dev = math.prod(axis_sizes(mesh).values())
    b = shape.global_batch
    if cfg.family in ("dense", "moe", "encdec"):
        total = b * shape.seq_len * cfg.n_layers * 2 * cfg.n_kv_heads * cfg.hd * 2
    elif cfg.family == "ssm":
        total = b * cfg.n_layers * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4 * 2
    else:  # hybrid: SSM states + the windowed attention cache
        ssm = b * cfg.n_layers * cfg.ssm_heads * cfg.ssm_headdim * cfg.ssm_state * 4 * 2
        alen = min(shape.seq_len, cfg.window) if cfg.window else shape.seq_len
        attn = (b * (cfg.n_layers // max(cfg.attn_every, 1)) * alen
                * 2 * cfg.n_kv_heads * cfg.hd * 2)
        total = ssm + attn
    return total / n_dev


def roofline_terms(cfg: ModelConfig, shape: ShapeConfig, mesh,
                   record: dict[str, Any]) -> dict[str, Any]:
    """The three terms, the bottleneck, the step's lower bound and the
    roofline fraction, from ``record["hlo"]``'s per-device ``dot_flops``
    and ``coll_bytes`` (and ``record["microbatch"]``)."""
    n_dev = math.prod(axis_sizes(mesh).values())
    flops_dev = record["hlo"]["dot_flops"]
    coll_bytes_dev = record["hlo"]["coll_bytes"]
    mem_bytes_dev = hbm_bytes(cfg, shape, mesh, record.get("microbatch", 0),
                              record.get("cache_bytes"))
    compute_s = flops_dev / PEAK_FLOPS
    memory_s = mem_bytes_dev / HBM_BW
    collective_s = coll_bytes_dev / LINK_BW
    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "hlo_flops_per_device": flops_dev,
        "hbm_bytes_per_device": mem_bytes_dev,
        "coll_bytes_per_device": coll_bytes_dev,
        "model_flops_total": model_flops(cfg, shape),
        "expected_hlo_flops_total": expected_hlo_flops(cfg, shape),
    }
    bound = max(compute_s, memory_s, collective_s)
    terms["bottleneck"] = ("compute" if bound == compute_s
                           else "memory" if bound == memory_s else "collective")
    # the bound assumes perfect overlap; the fraction is the share of it the
    # useful model FLOPs could sustain
    useful_s = terms["model_flops_total"] / n_dev / PEAK_FLOPS
    terms["step_lower_bound_s"] = bound
    terms["roofline_fraction"] = useful_s / bound if bound > 0 else 0.0
    terms["model_flops_ratio"] = (terms["model_flops_total"] / n_dev / flops_dev
                                  if flops_dev else 0.0)
    return terms
