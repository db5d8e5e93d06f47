"""Paper Table V + Eq. 12 on the PyTorch port: MAC-unit energies and the
3x3-conv energy ratio (``repro_torch.energy``).  The counterpart of
``table5_energy.py``.

    PYTHONPATH=src python benchmarks/torch_table5_energy.py
"""
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.energy import MAC_ENERGY_PJ, conv_energy_ratio  # noqa: E402


def run(quick: bool = True):
    t0 = time.perf_counter()
    rows = []
    for fw, e in MAC_ENERGY_PJ.items():
        rows.append((f"table5/{fw}", 0.0, f"mul={e['mul']}pJ acc={e['acc']}pJ"))
    r = conv_energy_ratio(3)
    rows.append(("table5/eq12_conv3x3_ratio", 0.0, f"{r:.2f}x (paper ~11.5x)"))
    us = (time.perf_counter() - t0) * 1e6 / len(rows)
    return [(n, us, d) for n, _, d in rows]


if __name__ == "__main__":
    print("name,us_per_call,derived")
    for name, us, derived in run():
        print(f'{name},{us:.1f},"{derived}"')
