"""Train a small LM (reduced glm4-9b family) with MLS low-bit matmuls
through the port's production stack: RunConfig -> make_train_step
(gradient accumulation, clipping, schedule) -> checkpoint and restart.
The port's counterpart of ``examples/train_lm_lowbit.py``.  ``--arch``
trains another arch's reduced config at the same sizes: an MoE
(``moonshot-v1-16b-a3b``, ``llama4-scout-17b-a16e``) or the
encoder-decoder ``seamless-m4t-medium``, whose batches carry random
frontend frames (``src_emb``, seq of them) for its encoder.

Run:  PYTHONPATH=src python examples/torch_train_lm_lowbit.py --steps 60
      (on the card; add --device cpu for the CPU, where the quantized
      kernels run their plain versions)
Scale up: --layers 12 --d-model 768 gives a ~100M model.
"""
import argparse
import dataclasses
import tempfile

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.data import make_lm_iterator
from repro_torch.models import lm
from repro_torch.runtime import resolve_device
from repro_torch.train import CheckpointManager, StragglerMonitor, make_train_step


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--no-quant", action="store_true")
    ap.add_argument("--backend", choices=["fake_quant", "pallas"], default="fake_quant",
                    help="pallas: every quantized GEMM on the port's K1/K3")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    cfg = dataclasses.replace(
        cfg, n_layers=args.layers, d_model=args.d_model, d_ff=args.d_model * 3 // 2,
        vocab=1024, quant=not args.no_quant, quant_backend=args.backend)
    print(f"model: {cfg.name} reduced, {cfg.n_params() / 1e6:.1f}M params, quant={cfg.quant}")

    run = RunConfig(model=cfg, shape=SHAPES["train_4k"], microbatch=args.microbatch,
                    optimizer="adamw", lr=3e-3)
    train_step, opt_init = make_train_step(run)

    model = lm.init_lm(cfg, seed=0, device=device)
    opt = opt_init(model)
    extras = ((("src_emb", (args.batch, args.seq, cfg.frontend_dim)),)
              if cfg.family == "encdec" else ())
    data = make_lm_iterator(batch=args.batch, seq=args.seq, vocab=cfg.vocab, extras=extras,
                            device=device)
    mon = StragglerMonitor()
    losses = []

    def state():
        return {"params": model.state_dict(), "opt": opt, "data": data.state_dict()}

    with tempfile.TemporaryDirectory() as td:
        mgr = CheckpointManager(td, keep=2)
        for i in range(args.steps):
            batch = next(data)
            mon.start()
            model, opt, m = train_step(model, opt, batch)
            loss = float(m["loss"])
            dt = mon.stop()
            losses.append(loss)
            if (i + 1) % max(args.steps // 10, 1) == 0:
                print(f"  step {i + 1}: loss={loss:.3f} gnorm={float(m['grad_norm']):.2f} "
                      f"lr={float(m['lr']):.2e} ({dt:.2f}s)")
            if (i + 1) % 25 == 0:
                mgr.save(i + 1, state(), blocking=False)
        mgr.wait()

        # fault-tolerance demo: restore and take one more step
        restored = None
        if mgr.latest_step():
            r = mgr.restore(state())
            model.load_state_dict(r["params"])
            data.load_state_dict(r["data"])
            _, _, m = train_step(model, r["opt"], next(data))
            restored = float(m["loss"])
            print(f"restored from step {mgr.latest_step()}, next-step loss={restored:.3f} "
                  f"(restart-reproducible)")
    print(f"straggler steps flagged: {mon.report()['straggler_steps']}")
    return {"losses": losses, "restored_loss": restored}


if __name__ == "__main__":
    main()
