"""Auditable graphs: one real training step or serving step of the port,
run under the coverage classifier.

``cifar_train_graph`` is one ResNet-20 step (loss, backward, SGD update)
with every quantized conv's three GEMMs on the port's kernels, at the
paper's ``k_block`` 128 (every conv on im2col) or at 144 (the 3x3 convs'
forward on the implicit-GEMM kernel).  Unlike the JAX package, which
traces abstract inputs, the port runs the step, on random weights and a
synthetic batch made from ``seed``: the launches it records are the
geometries a real step makes.  ``sabotage=True`` plants the JAX package's
unquantized fp32 ``h.T @ h`` on the hot path (folded into the loss, so it
runs): the negative control the gate must catch.

``serve_decode_graph`` is one LM decode step of a smoke-sized config
(qwen2-72b by default) with ``quant_backend="pallas"`` against a filled
cache (batch 4, cache length 128: a real prefill of 127 tokens), as the
JAX package's graph of that name: every quantized linear on K1 and K3,
the attention scores and the LM head in fp32.
"""
from __future__ import annotations

import collections
import dataclasses
from collections.abc import Callable

import torch
import torch.nn.functional as F

from repro_torch.configs import get_smoke_config
from repro_torch.core import FMT_IMAGENET, QuantConfig, fold_in
from repro_torch.data.synthetic import CifarIterator
from repro_torch.models import lm
from repro_torch.models.cnn import CNNConfig, init_cnn
from repro_torch.optim.optimizers import sgdm

from .coverage import CoverageReport, coverage_of_run

__all__ = ["AuditGraph", "cifar_train_graph", "serve_decode_graph"]


@dataclasses.dataclass
class AuditGraph:
    name: str
    step: Callable[[], None]
    qcfg: QuantConfig
    meta: dict

    def run(self) -> tuple[CoverageReport, collections.Counter]:
        """Run the step once: its coverage and its recorded kernel launches."""
        return coverage_of_run(self.step)


def cifar_train_graph(k_block: int = 128, width_mult: float = 1.0, in_hw: int = 32,
                      batch: int = 128, device: str | torch.device = "cuda",
                      sabotage: bool = False, seed: int = 0) -> AuditGraph:
    """One ResNet-20 training step at <2,4>, grouping "nc", stochastic
    rounding and ``k_block``, on ``device`` (CUDA unless asked for the CPU)."""
    cfg = CNNConfig("resnet20", width_mult=width_mult, in_hw=in_hw)
    qcfg = QuantConfig(fmt=FMT_IMAGENET, k_block=k_block, grouping="nc", stochastic=True)
    model = init_cnn(cfg, seed, device)
    opt = sgdm(model.parameters(), lr=0.05)
    b = next(CifarIterator(batch, in_hw, seed=seed, device=device))

    def step() -> None:
        logits = model(b["image"], qcfg, fold_in(seed, 0))
        loss = F.cross_entropy(logits, b["label"])
        if sabotage:
            # an unquantized fp32 GEMM on the hot path; the tiny weight keeps
            # the loss while its MACs run (they feed the loss)
            h = b["image"].reshape(batch, -1)
            loss = loss + 1e-12 * (h.T @ h).sum()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if not torch.isfinite(loss.detach()):
            raise FloatingPointError(f"train step gave a non-finite loss {float(loss)}")

    name = "train:resnet20" + ("" if k_block == 128 else f"@kb{k_block}")
    meta = {"kind": "train", "model": "resnet20", "k_block": k_block, "fmt": str(qcfg.fmt),
            "grouping": qcfg.grouping, "batch": batch, "in_hw": in_hw,
            "width_mult": width_mult, "device": str(torch.device(device)),
            "sabotage": sabotage}
    return AuditGraph(name, step, qcfg, meta)


SERVE_ARCH, SERVE_BATCH, SERVE_CACHE_LEN = "qwen2-72b", 4, 128  # the JAX package's graph


def serve_decode_graph(device: str | torch.device = "cuda", backend: str = "pallas",
                       seed: int = 0) -> AuditGraph:
    """One decode step of SERVE_ARCH's smoke config on ``quant_backend``
    ``backend`` ("fake_quant": the negative control), at position
    SERVE_CACHE_LEN - 1 of a cache that a prefill of random prompts filled
    (CUDA unless asked for the CPU)."""
    arch, batch, cache_len = SERVE_ARCH, SERVE_BATCH, SERVE_CACHE_LEN
    cfg = dataclasses.replace(get_smoke_config(arch), quant_backend=backend)
    model = lm.init_lm(cfg, seed, device)
    gen = torch.Generator(device=model.emb.device).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab, (batch, cache_len), generator=gen,
                           device=model.emb.device)
    _, cache = lm.prefill(model, {"tokens": tokens[:, :-1]}, cache_len)

    def step() -> None:
        logits, _ = lm.decode_step(model, cache, tokens[:, -1:])
        if not torch.isfinite(logits).all():
            raise FloatingPointError("the decode step gave non-finite logits")

    meta = {"kind": "serve", "model": arch, "backend": backend, "batch": batch,
            "cache_len": cache_len, "device": str(torch.device(device))}
    return AuditGraph(f"serve:{arch}", step, lm.serve_qcfg(cfg), meta)
