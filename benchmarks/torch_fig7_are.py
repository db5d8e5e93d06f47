"""Paper Fig. 7 on the PyTorch port: per-layer ARE of weight / activation /
error on a (reduced) ResNet-20 forward/backward over synthetic CIFAR.  The
counterpart of ``fig7_are.py``, with the same rows; its weights and batch
come from the port's seeded streams, so the values are close to, not
equal to, the JAX file's.

"Error" is dL/dZ per block (captured exactly by differentiating with
respect to a zero perturbation added to each block output), "activation"
is each block's input, "weight" each block's conv1 kernel: the three
tensor kinds the paper quantizes.

    PYTHONPATH=src python benchmarks/torch_fig7_are.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import FMT_CIFAR, GroupSpec  # noqa: E402
from repro_torch.core.quantize import average_relative_error, mls_quantize  # noqa: E402
from repro_torch.data import CifarIterator  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402
from repro_torch.models.cnn import CNNConfig, init_cnn  # noqa: E402
from repro_torch.runtime import resolve_device  # noqa: E402


def _forward_with_taps(model, x, zs):
    """ResNet-20's forward (fp32) with ``zs[i]`` added to block i's output;
    returns the logits and each block's input."""
    h = torch.relu(model.bn_stem(L.conv2d(x, model.stem.w, 1, "SAME", None)))
    acts = []
    for blk, z in zip(model.blocks, zs):
        acts.append(h)
        h = blk(h, None, None, 0) + z
    return L.linear(h.mean(dim=(2, 3)), model.fc.w, model.fc.b, None), acts


def run(quick: bool = True, device: str = "cuda"):
    device = resolve_device(device)
    cfg = CNNConfig(arch="resnet20", num_classes=10, width_mult=0.5, in_hw=16)
    model = init_cnn(cfg, 0, device)
    batch = next(CifarIterator(16, 16, device=device))
    # zero perturbations of each block's output shape
    with torch.no_grad():
        _, acts = _forward_with_taps(model, batch["image"], [0.0] * len(model.blocks))
        shapes = [blk(a, None, None, 0).shape for blk, a in zip(model.blocks, acts)]
    zs = [torch.zeros(s, device=device, requires_grad=True) for s in shapes]
    logits, acts = _forward_with_taps(model, batch["image"], zs)
    errors = torch.autograd.grad(F.cross_entropy(logits, batch["label"]), zs)  # dL/dZ
    weights = [blk.conv1.w for blk in model.blocks]

    t0 = time.perf_counter()
    rows = []
    with torch.no_grad():
        for kind, tensors in (("weight", weights), ("act", acts), ("err", errors)):
            for spec_name, spec in (("nc", GroupSpec.conv_nc()), ("none", None)):
                ares = [float(average_relative_error(
                    x, mls_quantize(x, FMT_CIFAR, spec).dequant())) for x in tensors]
                mean = sum(ares) / len(ares)
                rows.append((f"fig7/{kind}_{spec_name}", 0.0,
                             f"mean_ARE={mean:.4f} layers={['%.3f' % a for a in ares[:6]]}"))
    us = (time.perf_counter() - t0) * 1e6 / max(len(rows), 1)
    return [(n, us, d) for n, _, d in rows]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(device=args.device):
        print(f'{name},{us:.1f},"{derived}"')
