"""Paper Table VI on the PyTorch port: whole-network training energy, fp32
vs FP8 vs MLS, reproducing the 8.3-10.2x (vs fp32) and 1.9-2.3x (vs FP8)
claims from the port's op counter.  The counterpart of
``table6_energy_network.py``.

    PYTHONPATH=src python benchmarks/torch_table6_energy_network.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.energy import efficiency_ratios, network_energy  # noqa: E402
from repro_torch.models.cnn import CNNConfig  # noqa: E402

ARCHS = {
    "resnet18": CNNConfig(arch="resnet18", num_classes=1000, in_hw=224),
    "resnet34": CNNConfig(arch="resnet34", num_classes=1000, in_hw=224),
    "vgg16": CNNConfig(arch="vgg16", num_classes=1000, in_hw=224),
    "googlenet": CNNConfig(arch="googlenet", num_classes=1000, in_hw=224),
}


def run(quick: bool = True):
    rows = []
    for name, cfg in ARCHS.items():
        t0 = time.perf_counter()
        r = efficiency_ratios(cfg)
        mls = network_energy(cfg, "mls")
        fp32 = network_energy(cfg, "fp32")
        us = (time.perf_counter() - t0) * 1e6
        rows.append((
            f"table6/{name}", us,
            f"fp32={fp32['total_uj']:.0f}uJ mls={mls['total_uj']:.0f}uJ "
            f"ratio_fp32={r['vs_fp32']:.2f}x (paper 8.3-10.2) "
            f"ratio_fp8={r['vs_fp8']:.2f}x (paper 1.9-2.3)",
        ))
    return rows


if __name__ == "__main__":
    print("name,us_per_call,derived")
    for name, us, derived in run():
        print(f'{name},{us:.1f},"{derived}"')
