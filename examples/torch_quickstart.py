"""Quickstart: the MLS tensor format end to end, on the PyTorch port.

The port's counterpart of ``examples/quickstart.py``:

1. dynamically quantize a tensor (paper Alg. 2) and inspect the three
   scaling levels,
2. run a low-bit matmul with the training semantics (paper Alg. 1),
3. run the quantized-domain kernels, K1 (``mls_quantize``) and K3
   (``mls_matmul``), and check each is bit-identical to its plain PyTorch
   version (``quantize_ref``, ``mls_matmul_ref``) on the same inputs.

Run:  PYTHONPATH=src python examples/torch_quickstart.py
      (on the card; --device cpu runs the kernels' plain versions)
"""
import argparse

import torch

from repro_torch.core import FMT_IMAGENET, GroupSpec, QuantConfig
from repro_torch.core.lowbit import lowbit_matmul
from repro_torch.core.quantize import average_relative_error, mls_quantize
from repro_torch.kernels import mls_matmul, mls_matmul_ref, quantize_ref, rounding_bytes
from repro_torch.kernels import mls_quantize as k1_quantize
from repro_torch.runtime import resolve_device


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(0)

    print(f"== 1. dynamic quantization to MLS {FMT_IMAGENET} ==")
    scale = 10 ** (torch.rand((8, 1), generator=gen, device=device) * 3.0 - 2.0)
    x = torch.randn((8, 256), generator=gen, device=device) * scale
    t = mls_quantize(x, FMT_IMAGENET, GroupSpec((1, 128)))
    print(f"  tensor scale  S_t = {float(t.s_t):.4f}")
    print(f"  group scales  S_g = {t.s_g[:2].cpu().numpy().round(4).tolist()} ... "
          f"(<8,1> ceil-quantized, shape {tuple(t.s_g.shape)})")
    print(f"  element codes: exp in [0,3], man in [0,15]; packed "
          f"{FMT_IMAGENET.element_bits} bits/elem")
    are = float(average_relative_error(x, t.dequant()))
    are_pt = float(average_relative_error(x, mls_quantize(x, FMT_IMAGENET, None).dequant()))
    print(f"  ARE: group-wise={are:.4f}  vs per-tensor={are_pt:.4f} "
          f"(group scaling wins, paper Table IV)")

    print("== 2. low-bit training matmul (Alg. 1 semantics, STE grads) ==")
    w = (torch.randn((256, 64), generator=gen, device=device) * 0.05).requires_grad_()
    cfg = QuantConfig(fmt=FMT_IMAGENET, backend="fake_quant")
    y = lowbit_matmul(x, w, 3, cfg)
    ref = x @ w.detach()
    rel = float(torch.linalg.norm(y.detach() - ref) / torch.linalg.norm(ref))
    y.sum().backward()
    print(f"  fwd rel err vs fp32: {rel:.4f}; grad norm {float(torch.linalg.norm(w.grad)):.3f}")

    print("== 3. K1 and K3 against their plain versions ==")
    kb = 128
    xp = torch.nn.functional.pad(x, (0, 0, 0, 120)).contiguous()  # 128 rows
    wt = w.detach().t().contiguous()  # (N, K): K3 reads the weight's codes K-contiguous
    rx, rw = rounding_bytes(xp.shape, gen, device), rounding_bytes(wt.shape, gen, device)
    xq, wq = (k1_quantize(t, FMT_IMAGENET, kb, r_u8=r) for t, r in ((xp, rx), (wt, rw)))
    xr, wr = (quantize_ref(t, FMT_IMAGENET, kb, r_u8=r) for t, r in ((xp, rx), (wt, rw)))
    k1_same = all(torch.equal(a, b) for a, b in zip((*xq, *wq), (*xr, *wr)))
    args3 = (xq[0], xq[1], xq[2], wq[0].t(), wq[1].t(), wq[2], FMT_IMAGENET, kb)
    yk, yr = mls_matmul(*args3), mls_matmul_ref(*args3)
    k3_same = torch.equal(yk, yr)
    rel = float(torch.linalg.norm(yk[:8] - ref) / torch.linalg.norm(ref))
    print(f"  K1 ({'kernel' if device.type == 'cuda' else 'plain version'}) vs plain version "
          f"bit-identical: {k1_same}")
    print(f"  K3 vs plain version bit-identical: {k3_same}; rel err vs fp32: {rel:.4f}")
    if not (k1_same and k3_same):
        raise SystemExit("a kernel differs from its plain version")
    return {"x": x.cpu(), "unit": t.dequant().cpu(), "are": are, "are_per_tensor": are_pt,
            "k1_identical": k1_same,
            "k3_identical": k3_same, "qd_rel_err": rel}


if __name__ == "__main__":
    main()
