"""Paper Table IV / Fig. 7 rows 1-3 on the PyTorch port: ARE of
quantization under (grouping dims) x (Mg) x (Ex) x (Mx), on a tensor with
realistic statistics (per-(n, c) scale diversity like real activations and
errors).  The counterpart of ``table4_ablation.py``, with the same rows;
its tensor is drawn from a ``torch.Generator`` (seed 0), so the ARE
values are close to, not equal to, the JAX file's.

    PYTHONPATH=src python benchmarks/torch_table4_ablation.py [--device cpu]
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.core import GS_FMT_DEFAULT, EMFormat, GroupSpec  # noqa: E402
from repro_torch.core.quantize import average_relative_error, mls_quantize  # noqa: E402
from repro_torch.runtime import resolve_device  # noqa: E402

GROUPINGS = {
    "1": None,  # no group scaling
    "c": GroupSpec((None, 1, None, None)),
    "n": GroupSpec((1, None, None, None)),
    "nc": GroupSpec.conv_nc(),
}


def _tensor(device) -> torch.Tensor:
    """Activation-like: per-(n, c) scales spanning ~3 decades (cf. Fig. 6)."""
    g = torch.Generator().manual_seed(0)
    scales = 10.0 ** (torch.rand((16, 32, 1, 1), generator=g) * 3.0 - 2.0)
    return (torch.randn((16, 32, 8, 8), generator=g) * scales).to(device)


def run(quick: bool = True, device: str = "cuda"):
    x = _tensor(resolve_device(device))
    def are(fmt, spec, gs=EMFormat(8, 1)) -> float:
        return float(average_relative_error(x, mls_quantize(x, fmt, spec, gs).dequant()))

    rows = []
    t0 = time.perf_counter()
    # grouping dim ablation (Ex=0 equivalent: <0,3>)
    for gname, spec in GROUPINGS.items():
        for mg in (0, 1):
            rows.append((f"table4/group_{gname}_mg{mg}_e0m3", 0.0,
                         f"ARE={are(EMFormat(0, 3), spec, EMFormat(8, mg)):.4f}"))
    # element exponent ablation (no grouping, the default group-scale format)
    for ex in (0, 1, 2):
        rows.append((f"table4/nogroup_e{ex}m3", 0.0,
                     f"ARE={are(EMFormat(ex, 3), None, GS_FMT_DEFAULT):.4f}"))
    # joint (nc, Mg=1) x Ex x Mx grid
    for ex in (0, 1, 2):
        for mx in (1, 2, 3, 4):
            rows.append((f"table4/nc_mg1_e{ex}m{mx}", 0.0,
                         f"ARE={are(EMFormat(ex, mx), GroupSpec.conv_nc()):.4f}"))
    us = (time.perf_counter() - t0) * 1e6 / max(len(rows), 1)
    return [(n, us, d) for n, _, d in rows]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    print("name,us_per_call,derived")
    for name, us, derived in run(device=args.device):
        print(f'{name},{us:.1f},"{derived}"')
