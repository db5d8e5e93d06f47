"""The paper's CNN zoo as ``nn.Module``s: ResNet-20/18/34, VGG-16 and
GoogleNet (``src/repro/models/cnn.py``).

Per the paper (Sec. VI-A) the first conv and the final classifier stay
unquantized; BN runs in fp32.  Every quantized conv has its own
stochastic-rounding site tag, folded into the step's key: ResNet blocks
``3i``, ``3i+1``, ``3i+2`` (conv1, conv2, projection); VGG conv ``i``;
GoogleNet stem 1/2, inception module ``i`` ``10 + 6i + branch``.  The
ImageNet-size ResNets take the 7x7 stride-2 stem and a 3x3/2 "SAME" max
pool; GoogleNet is the BN variant without aux heads, whose stem pools
only when ``in_hw >= 128``.  Parameter names mirror the JAX pytree
(``blocks.3.conv1.w``, ``convs.3.conv.w``, ``inception.4.b5.conv.w``,
``stem1.bn.gamma``), so :func:`repro_torch.convert.cnn_params_from_jax`
maps one to the other.

``CNN.forward(x, qcfg, key)``: ``qcfg`` quantizes every conv but the
first (``None``: fp32), ``key`` (an int, one per step) seeds the rounding
streams.  :func:`count_ops` runs a model under
:class:`~repro_torch.models.nn.OpTrace` on the ``meta`` device: the exact
per-layer op counts of the paper's Table I, with no memory allocated.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.lowbit import QuantConfig, conv_pads, fold_in
from repro_torch.kernels.implicit_conv import ConvGeom, conv_geometry
from repro_torch.runtime import resolve_device

from . import nn as L

__all__ = ["ARCHS", "CNN", "CNNConfig", "GoogleNet", "ResNet", "VGG16", "build_cnn",
           "count_ops", "init_cnn", "quantized_convs"]


@dataclasses.dataclass(frozen=True)
class CNNConfig:
    arch: str = "resnet20"  # resnet20 | resnet18 | resnet34 | vgg16 | googlenet
    num_classes: int = 10
    width_mult: float = 1.0
    in_hw: int = 32  # 32 for CIFAR, 224 for the ImageNet variants
    in_ch: int = 3

    def scaled(self, c: int) -> int:
        return max(4, int(round(c * self.width_mult)))


def max_pool(x: torch.Tensor, k: int, s: int, padding: str) -> torch.Tensor:
    """``lax.reduce_window(max)`` with JAX's padding rule (-inf padding)."""
    (ph_lo, ph_hi), (pw_lo, pw_hi) = conv_pads(x.shape[2:], (k, k), (s, s), padding)
    xp = F.pad(x, (pw_lo, pw_hi, ph_lo, ph_hi), value=-math.inf)
    return F.max_pool2d(xp, k, s)


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


class ConvBN(nn.Module):
    """conv -> BN -> ReLU, the unit of VGG and GoogleNet (``conv``, ``bn``)."""

    def __init__(self, c_in: int, c_out: int, k: int):
        super().__init__()
        self.conv, self.bn = Conv(c_in, c_out, k), BatchNorm(c_out)

    def forward(self, x, stride, qcfg, key):
        return torch.relu(self.bn(L.conv2d(x, self.conv.w, stride, "SAME", qcfg, key)))


class CNN(nn.Module):
    """A model of the zoo: ``forward(x, qcfg=None, key=None)`` -> logits."""

    cfg: CNNConfig


# ---------------------------------------------------------------------------
# ResNet (CIFAR basic-block and ImageNet basic-block variants)
# ---------------------------------------------------------------------------
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


# depths, widths, ImageNet stem
_RESNET_STAGES = {
    "resnet20": ([3, 3, 3], [16, 32, 64], False),
    "resnet18": ([2, 2, 2, 2], [64, 128, 256, 512], True),
    "resnet34": ([3, 4, 6, 3], [64, 128, 256, 512], True),
}


class ResNet(CNN):
    """Basic-block ResNet: the CIFAR 3x3 stem (ResNet-20) or the ImageNet
    7x7/2 stem with a 3x3/2 max pool (ResNet-18/34)."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        depths, widths, self.imagenet_stem = _RESNET_STAGES[cfg.arch]
        widths = [cfg.scaled(w) for w in widths]
        self.cfg = cfg
        self.stem = Conv(cfg.in_ch, widths[0], 7 if self.imagenet_stem else 3)
        self.bn_stem = BatchNorm(widths[0])
        blocks, c_in = [], widths[0]
        for si, (d, w) in enumerate(zip(depths, widths)):
            for bi in range(d):
                blocks.append(BasicBlock(c_in, w, 2 if (bi == 0 and si > 0) else 1))
                c_in = w
        self.blocks = nn.ModuleList(blocks)
        self.fc = Linear(c_in, cfg.num_classes)

    def forward(self, x, qcfg: QuantConfig | None = None, key: int | None = None):
        # first layer unquantized (paper Sec. VI-A)
        h = L.conv2d(x, self.stem.w, 2 if self.imagenet_stem else 1, "SAME", None)
        h = torch.relu(self.bn_stem(h))
        if self.imagenet_stem:
            h = max_pool(h, 3, 2, "SAME")
        for i, blk in enumerate(self.blocks):
            h = blk(h, qcfg, key, 3 * i)
        h = h.mean(dim=(2, 3))
        return L.linear(h, self.fc.w, self.fc.b, None)  # last layer unquantized


# ---------------------------------------------------------------------------
# VGG-16
# ---------------------------------------------------------------------------
_VGG16 = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
          512, 512, 512, "M", 512, 512, 512, "M"]


class VGG16(CNN):
    """VGG-16 with BN, 2x2 max pools; the first conv stays unquantized."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        self.cfg = cfg
        convs, c_in = [], cfg.in_ch
        for v in _VGG16:
            if v != "M":
                convs.append(ConvBN(c_in, cfg.scaled(v), 3))
                c_in = cfg.scaled(v)
        self.convs = nn.ModuleList(convs)
        self.fc = Linear(c_in, cfg.num_classes)

    def forward(self, x, qcfg: QuantConfig | None = None, key: int | None = None):
        h, ci = x, 0
        for v in _VGG16:
            if v == "M":
                h = max_pool(h, 2, 2, "VALID")
                continue
            q = None if ci == 0 else qcfg  # first conv unquantized
            h = self.convs[ci](h, 1, q, fold_in(key, ci))
            ci += 1
        h = h.mean(dim=(2, 3))
        return L.linear(h, self.fc.w, self.fc.b, None)


# ---------------------------------------------------------------------------
# GoogleNet (Inception v1, BN variant, no aux heads)
# ---------------------------------------------------------------------------
# (name, 1x1, (3x3red, 3x3), (5x5red, 5x5), pool_proj); "M" is a 3x3/2 max pool
_INCEPTION = [
    ("3a", 64, (96, 128), (16, 32), 32),
    ("3b", 128, (128, 192), (32, 96), 64),
    ("M", 0, (0, 0), (0, 0), 0),
    ("4a", 192, (96, 208), (16, 48), 64),
    ("4b", 160, (112, 224), (24, 64), 64),
    ("4c", 128, (128, 256), (24, 64), 64),
    ("4d", 112, (144, 288), (32, 64), 64),
    ("4e", 256, (160, 320), (32, 128), 128),
    ("M", 0, (0, 0), (0, 0), 0),
    ("5a", 256, (160, 320), (32, 128), 128),
    ("5b", 384, (192, 384), (48, 128), 128),
]


class Inception(nn.Module):
    def __init__(self, c_in: int, cfg: CNNConfig, spec):
        super().__init__()
        _, c1, (c3r, c3), (c5r, c5), cp = spec
        s = cfg.scaled
        self.b1 = ConvBN(c_in, s(c1), 1)
        self.b3r, self.b3 = ConvBN(c_in, s(c3r), 1), ConvBN(s(c3r), s(c3), 3)
        self.b5r, self.b5 = ConvBN(c_in, s(c5r), 1), ConvBN(s(c5r), s(c5), 5)
        self.bp = ConvBN(c_in, s(cp), 1)
        self.c_out = s(c1) + s(c3) + s(c5) + s(cp)

    def forward(self, x, qcfg, key, tag: int):
        b1 = self.b1(x, 1, qcfg, fold_in(key, tag))
        b3 = self.b3(self.b3r(x, 1, qcfg, fold_in(key, tag + 1)), 1, qcfg, fold_in(key, tag + 2))
        b5 = self.b5(self.b5r(x, 1, qcfg, fold_in(key, tag + 3)), 1, qcfg, fold_in(key, tag + 4))
        bp = self.bp(max_pool(x, 3, 1, "SAME"), 1, qcfg, fold_in(key, tag + 5))
        return torch.cat([b1, b3, b5, bp], dim=1)


class GoogleNet(CNN):
    """Inception v1 with BN; stem 7x7 (unquantized), 1x1, 3x3."""

    def __init__(self, cfg: CNNConfig):
        super().__init__()
        self.cfg = cfg
        s = cfg.scaled
        self.stem1 = ConvBN(cfg.in_ch, s(64), 7)
        self.stem2 = ConvBN(s(64), s(64), 1)
        self.stem3 = ConvBN(s(64), s(192), 3)
        mods, c_in = [], s(192)
        for spec in _INCEPTION:
            if spec[0] != "M":
                mods.append(Inception(c_in, cfg, spec))
                c_in = mods[-1].c_out
        self.inception = nn.ModuleList(mods)
        self.fc = Linear(c_in, cfg.num_classes)

    def forward(self, x, qcfg: QuantConfig | None = None, key: int | None = None):
        imagenet = self.cfg.in_hw >= 128
        h = self.stem1(x, 2 if imagenet else 1, None, None)  # unquantized
        if imagenet:
            h = max_pool(h, 3, 2, "SAME")
        h = self.stem2(h, 1, qcfg, fold_in(key, 1))
        h = self.stem3(h, 1, qcfg, fold_in(key, 2))
        if imagenet:
            h = max_pool(h, 3, 2, "SAME")
        mi = 0
        for spec in _INCEPTION:
            if spec[0] == "M":
                h = max_pool(h, 3, 2, "SAME")
                continue
            h = self.inception[mi](h, qcfg, key, 10 + 6 * mi)
            mi += 1
        h = h.mean(dim=(2, 3))
        return L.linear(h, self.fc.w, self.fc.b, None)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------
ARCHS = {"resnet20": ResNet, "resnet18": ResNet, "resnet34": ResNet, "vgg16": VGG16,
         "googlenet": GoogleNet}


def build_cnn(cfg: CNNConfig) -> CNN:
    """The model of ``cfg.arch``, parameters uninitialized."""
    if cfg.arch not in ARCHS:
        raise ValueError(f"unknown arch {cfg.arch!r}; expected one of {sorted(ARCHS)}")
    return ARCHS[cfg.arch](cfg)


def init_cnn(cfg: CNNConfig, seed: int = 0, device: str | torch.device = "cuda") -> CNN:
    """A model with random weights from ``seed`` (Kaiming-normal convs,
    Xavier-uniform classifier, unit BN), on ``device`` (CUDA by default)."""
    device = resolve_device(device)
    model = build_cnn(cfg)
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


def count_ops(cfg: CNNConfig, batch: int = 1) -> list[tuple[str, dict]]:
    """Exact op counts of one forward pass (paper Table I methodology):
    the model runs unquantized under :class:`~.nn.OpTrace` on the ``meta``
    device, so only shapes are computed."""
    with torch.device("meta"):
        model = build_cnn(cfg)
        x = torch.empty((batch, cfg.in_ch, cfg.in_hw, cfg.in_hw))
    with L.OpTrace() as tr, torch.no_grad():
        model(x)
    return tr.ops


def quantized_convs(cfg: CNNConfig, batch: int) -> list[ConvGeom]:
    """The geometry of every quantized conv of one forward pass, in call
    order: the model runs on the ``meta`` device under
    :class:`~.nn.OpTrace` with a disabled ``QuantConfig``, so the convs a
    config would quantize are traced through the fp32 path."""
    with torch.device("meta"):
        model = build_cnn(cfg)
        x = torch.empty((batch, cfg.in_ch, cfg.in_hw, cfg.in_hw))
    with L.OpTrace() as tr, torch.no_grad():
        model(x, QuantConfig(enabled=False))
    return [conv_geometry(xs, ws, s, pad) for xs, ws, s, pad, site in tr.convs if site]
