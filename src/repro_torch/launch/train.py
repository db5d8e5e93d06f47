"""LM training launcher.

    python -m repro_torch.launch.train --arch mamba2-370m --shape train_4k \
        --steps 1000 --ckpt-dir ckpts/mamba2

builds the (optionally microbatched) train step of
:func:`repro_torch.train.make_train_step`, makes the model on the card
from the run's seed, and runs the loop with asynchronous checkpoints
(params, optimizer state and the data stream's position), resume from the
latest one, and straggler monitoring; it prints every 10 steps.  It runs
on CUDA unless ``--device cpu`` is given.  ``--smoke`` trains the arch's
reduced config (batch 8, seq 64 unless overridden), with no accumulation.
The JAX launcher's ``--multi-pod`` (a mesh across pods) is not offered
until ``parallel`` is ported (ROADMAP queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import SHAPES, RunConfig, get_config, get_smoke_config
from repro_torch.configs import shape_model_config
from repro_torch.data import make_lm_iterator
from repro_torch.models import lm
from repro_torch.runtime import resolve_device
from repro_torch.train import CheckpointManager, StragglerMonitor, make_train_step

from .specs import choose_microbatch

__all__ = ["main"]


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k", choices=sorted(SHAPES))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--batch", type=int, default=0, help="override batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    shape = SHAPES[args.shape]
    if args.smoke:
        cfg = get_smoke_config(args.arch)
        batch_size, seq = args.batch or 8, args.seq or 64
    else:
        cfg = shape_model_config(get_config(args.arch), shape)
        batch_size, seq = args.batch or shape.global_batch, args.seq or shape.seq_len
    # the cell as run: with --batch/--seq the JAX launcher sizes the
    # accumulation by the shape's own batch, which need not divide the batch
    run_shape = dataclasses.replace(shape, global_batch=batch_size, seq_len=seq)
    mb = choose_microbatch(cfg, run_shape, dp=1) if not args.smoke else 0
    run = RunConfig(model=cfg, shape=run_shape, microbatch=mb)
    train_step, opt_init = make_train_step(run)

    model = lm.init_lm(cfg, seed=run.seed, device=device)
    opt = opt_init(model)
    data = make_lm_iterator(batch=batch_size, seq=seq, vocab=cfg.vocab, device=device)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start = 0
    if mgr and mgr.latest_step() is not None:
        st = mgr.restore({"params": model.state_dict(), "opt": opt, "data": data.state_dict()})
        model.load_state_dict(st["params"])
        opt, start = st["opt"], mgr.latest_step()
        data.load_state_dict(st["data"])
        print(f"resumed from step {start}")

    mon = StragglerMonitor()
    losses = []
    for i in range(start, args.steps):
        batch = next(data)
        mon.start()
        model, opt, metrics = train_step(model, opt, batch)
        loss = float(metrics["loss"])  # waits for the step
        dt = mon.stop()
        losses.append(loss)
        if (i + 1) % 10 == 0 or i == start:
            print(f"step {i + 1}: loss={loss:.4f} gnorm={float(metrics['grad_norm']):.2f} "
                  f"{dt:.2f}s")
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, {"params": model.state_dict(), "opt": opt,
                             "data": data.state_dict()}, blocking=False)
    if mgr:
        mgr.wait()
    report = mon.report()
    print("straggler report:", report)
    return {"start": start, "losses": losses, "straggler": report, "microbatch": mb}


if __name__ == "__main__":
    main()
