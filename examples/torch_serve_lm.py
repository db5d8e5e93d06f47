"""Batched serving demo of the PyTorch port: prefill a batch of prompts,
then decode with the KV/SSM cache (MLS nearest-rounding quantized weights
and activations at inference).  The counterpart of ``examples/serve_lm.py``.

Run on the card:  PYTHONPATH=src python examples/torch_serve_lm.py --tokens 32 --batch 4
On the CPU:       PYTHONPATH=src python examples/torch_serve_lm.py --device cpu
Every family serves: ``--arch moonshot-v1-16b-a3b`` or
``llama4-scout-17b-a16e`` (MoE), ``seamless-m4t-medium`` (encoder-decoder:
the prompts come with ``--src-len`` random frames of its audio frontend's
embeddings for the encoder), ``mamba2-370m``, ``zamba2-7b``, and the dense
configs.
``--full`` serves the architecture's full config instead of its reduced
smoke config (random weights; chatglm3-6b's take 25 GB on the card).
``--backend pallas`` runs every quantized linear on the port's kernels (K1
on both operands, then K3); ``fake_quant`` (the config's default) on the
fake-quant simulation.
"""
import argparse
import dataclasses
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402

from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.serve import ServeEngine  # noqa: E402


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-72b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--src-len", type=int, default=32,
                    help="encoder frames per prompt (encoder-decoder archs)")
    ap.add_argument("--backend", choices=["fake_quant", "pallas"], default=None,
                    help="quant_backend of the config (default: the config's own)")
    ap.add_argument("--full", action="store_true",
                    help="the full config instead of the reduced smoke config")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_config if args.full else get_smoke_config)(args.arch)
    if args.backend is not None:
        cfg = dataclasses.replace(cfg, quant_backend=args.backend)
    model = lm.init_lm(cfg, seed=0, device=args.device)
    engine = ServeEngine(cfg, model, max_len=args.prompt_len + args.tokens, device=args.device)
    dev = engine.device
    gen = torch.Generator(device=dev).manual_seed(1)
    prompts = {"tokens": torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                                       generator=gen, device=dev)}
    if cfg.family == "encdec":
        prompts["src_emb"] = torch.randn((args.batch, args.src_len, cfg.frontend_dim),
                                         generator=gen, device=dev)

    print(f"serving {'full' if args.full else 'reduced'} {cfg.name} on {dev}: "
          f"batch={args.batch} prompt={args.prompt_len} gen={args.tokens}")
    with torch.inference_mode():
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompts)
        tok = torch.argmax(logits, -1)[:, None]
        _sync(dev)
        print(f"prefill: {time.perf_counter() - t0:.2f}s "
              f"({args.batch * args.prompt_len} tokens)")
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(args.tokens - 1):
            logits, cache = engine.decode(cache, tok)
            tok = torch.argmax(logits, -1)[:, None]
            out.append(tok)
        _sync(dev)
    dt = time.perf_counter() - t0
    n = args.batch * (args.tokens - 1)
    print(f"decode: {dt:.2f}s -> {n / dt:.1f} tok/s (batch={args.batch})")
    seqs = torch.cat(out, dim=1)
    print("sample generations (token ids):")
    for row in seqs[:2]:
        print("  ", row[:16].tolist())
    return seqs


if __name__ == "__main__":
    main()
