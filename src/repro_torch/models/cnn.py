"""The paper's CIFAR ResNet-20 as an ``nn.Module``.

Per the paper (Sec. VI-A) the first conv and the final classifier stay
unquantized; BN runs in fp32.  Every quantized conv gets its own
stochastic-rounding site tag (``tag``, ``tag+1``, ``tag+2`` for a block's
conv1, conv2 and projection, stepping by 3 per block), folded into the
step's key.  Parameter names mirror the JAX pytree (``blocks.3.conv1.w``),
so :func:`repro_torch.convert.resnet_params_from_jax` maps one to the other.
ResNet-18/34, VGG-16 and GoogleNet are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core.lowbit import QuantConfig, fold_in
from repro_torch.runtime import resolve_device

from . import nn as L

__all__ = ["CNNConfig", "ResNet", "init_resnet"]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch: str = "resnet20"
    num_classes: int = 10
    width_mult: float = 1.0
    in_hw: int = 32
    in_ch: int = 3

    def scaled(self, c: int) -> int:
        return max(4, int(round(c * self.width_mult)))


_RESNET_STAGES = {"resnet20": ([3, 3, 3], [16, 32, 64])}


class Conv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(c_out, c_in, k, k))


class BatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(c))
        self.beta = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return L.batchnorm(x, self.gamma, self.beta)


class Linear(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))


class BasicBlock(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int):
        super().__init__()
        self.stride = stride
        self.conv1, self.bn1 = Conv(c_in, c_out, 3), BatchNorm(c_out)
        self.conv2, self.bn2 = Conv(c_out, c_out, 3), BatchNorm(c_out)
        if stride != 1 or c_in != c_out:
            self.proj, self.bn_proj = Conv(c_in, c_out, 1), BatchNorm(c_out)

    def forward(self, x, qcfg, key, tag: int):
        h = L.conv2d(x, self.conv1.w, self.stride, "SAME", qcfg, fold_in(key, tag))
        h = torch.relu(self.bn1(h))
        h = L.conv2d(h, self.conv2.w, 1, "SAME", qcfg, fold_in(key, tag + 1))
        h = self.bn2(h)
        if hasattr(self, "proj"):
            x = self.bn_proj(
                L.conv2d(x, self.proj.w, self.stride, "SAME", qcfg, fold_in(key, tag + 2)))
        return torch.relu(L.ew_add(h, x))


class ResNet(nn.Module):
    """CIFAR ResNet (basic blocks, 3x3 stem).  ``forward(x, qcfg, key)``:
    ``qcfg`` quantizes every conv of the blocks, ``key`` (an int, one per
    step) seeds their rounding streams."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        if cfg.arch not in _RESNET_STAGES:
            raise NotImplementedError(
                f"arch {cfg.arch!r} is not ported yet (ROADMAP.md queue 1, item 8)")
        depths, widths = _RESNET_STAGES[cfg.arch]
        widths = [cfg.scaled(w) for w in widths]
        self.cfg = cfg
        self.stem, self.bn_stem = Conv(cfg.in_ch, widths[0], 3), BatchNorm(widths[0])
        blocks, c_in = [], widths[0]
        for si, (d, w) in enumerate(zip(depths, widths)):
            for bi in range(d):
                blocks.append(BasicBlock(c_in, w, 2 if (bi == 0 and si > 0) else 1))
                c_in = w
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(c_in, cfg.num_classes)

    def forward(self, x, qcfg: QuantConfig | None = None, key: int | None = None):
        h = L.conv2d(x, self.stem.w, 1, "SAME", None)  # first layer unquantized
        h = torch.relu(self.bn_stem(h))
        for i, blk in enumerate(self.blocks):
            h = blk(h, qcfg, key, 3 * i)
        h = h.mean(dim=(2, 3))
        return L.linear(h, self.fc.w, self.fc.b, None)  # last layer unquantized


def init_resnet(cfg: CNNConfig, seed: int = 0, device: str | torch.device = "cuda") -> ResNet:
    """A ResNet with random weights from ``seed`` (Kaiming-normal convs,
    Xavier-uniform classifier, unit BN), on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    model = ResNet(cfg)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(".w") and p.ndim == 4:
                fan_in = p.shape[1] * p.shape[2] * p.shape[3]
                p.copy_(torch.randn(p.shape, generator=g) * math.sqrt(2.0 / fan_in))
            elif name == "fc.w":
                lim = math.sqrt(6.0 / (p.shape[0] + p.shape[1]))
                p.copy_((torch.rand(p.shape, generator=g) * 2 - 1) * lim)
    return model.to(device)
