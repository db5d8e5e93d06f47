"""Paper Table I on the PyTorch port: op counts of one ImageNet training
step (per image), from ``repro_torch.models.cnn.count_ops`` (shapes only,
on the ``meta`` device).  The counterpart of ``table1_opcounts.py``.

    PYTHONPATH=src python benchmarks/torch_table1_opcounts.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.models.cnn import CNNConfig, count_ops  # noqa: E402

PAPER = {  # (fwd conv MACs, fc MACs, ew-adds)
    "resnet18": (1.88e9, 5.12e5, 7.53e5),
    "googlenet": (1.58e9, 1.02e6, 0.0),
}


def run(quick: bool = True):
    rows = []
    for arch, (conv_ref, fc_ref, ew_ref) in PAPER.items():
        t0 = time.perf_counter()
        ops = count_ops(CNNConfig(arch=arch, num_classes=1000, in_hw=224))
        us = (time.perf_counter() - t0) * 1e6
        conv = sum(d["c_in"] * d["c_out"] * d["k"] ** 2 * d["h"] * d["w"]
                   for k, d in ops if k == "conv")
        fc = sum(d["d_in"] * d["d_out"] * d["rows"] for k, d in ops if k == "fc")
        ew = sum(d["numel"] for k, d in ops if k == "ew_add")
        rows.append((f"table1/{arch}_conv_macs", us, f"{conv:.3e} (paper {conv_ref:.2e})"))
        rows.append((f"table1/{arch}_fc_macs", us, f"{fc:.3e} (paper {fc_ref:.2e})"))
        rows.append((f"table1/{arch}_ew_adds", us, f"{ew:.3e} (paper {ew_ref:.2e})"))
    return rows


if __name__ == "__main__":
    print("name,us_per_call,derived")
    for name, us, derived in run():
        print(f'{name},{us:.1f},"{derived}"')
