"""End-to-end driver of the PyTorch port (the paper's own experiment at
reduced scale): train ResNet-20 on (synthetic) CIFAR with the MLS low-bit
training framework and compare against the fp32 baseline, with
checkpoints every 50 steps (atomic, asynchronous) and straggler
monitoring along the way.  The counterpart of
``examples/train_cifar_lowbit.py``.

Run on the card:  PYTHONPATH=src python examples/torch_train_cifar_lowbit.py --steps 200
On the CPU:       PYTHONPATH=src python examples/torch_train_cifar_lowbit.py --device cpu \\
                      --steps 4 --batch 8 --hw 8 --width 0.25
(--width 1.0 --hw 32 --batch 128 --steps 1000 approaches the real
ResNet-20 setup.)  ``--backend quantized`` runs the three training GEMMs
of every quantized conv in the MLS quantized domain on the CUDA kernels;
``fake_quant`` (the default, as in the JAX driver) quantizes and
dequantizes the operands around fp32 convs.
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import FMT_CIFAR, FMT_IMAGENET, QuantConfig  # noqa: E402
from repro_torch.core.lowbit import BACKENDS  # noqa: E402
from repro_torch.train import CheckpointManager  # noqa: E402
from repro_torch.train.loop import train_variant  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--hw", type=int, default=16)
    ap.add_argument("--width", type=float, default=0.5)
    ap.add_argument("--backend", choices=BACKENDS, default="fake_quant",
                    help="arithmetic of the quantized convs: fake-quant simulation or the "
                         "quantized-domain CUDA kernels")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    variants = [
        ("fp32", None),
        ("mls<2,4>", QuantConfig(fmt=FMT_IMAGENET, backend=args.backend)),
        ("mls<2,1>", QuantConfig(fmt=FMT_CIFAR, backend=args.backend)),
    ]
    results, accs = {}, {}
    with tempfile.TemporaryDirectory() as td:
        for name, qcfg in variants:
            print(f"== training {name} ==")
            mgr = CheckpointManager(f"{td}/{name}", keep=2) if qcfg is not None else None
            res = train_variant(name, qcfg, args.steps, args.width, args.hw, args.batch,
                                device=args.device, ckpt=mgr,
                                log_every=max(args.steps // 10, 1))
            if mgr is not None:
                print(f"  [{name}] checkpoints: latest step {mgr.latest_step()}, "
                      f"straggler report {res.straggler['straggler_steps']}")
            k = max(len(res.accs) // 5, 1)
            results[name], accs[name] = res, sum(res.accs[-k:]) / k
    print("\n== final accuracy (paper Table II analogue) ==")
    for name, acc in accs.items():
        print(f"  {name:10s} acc={acc:.3f} drop={accs['fp32'] - acc:+.3f}")
    return results


if __name__ == "__main__":
    main()
