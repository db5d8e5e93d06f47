"""Convergence-proxy runner: one short training run per frontier cell.

The port of the JAX package's ``sweep/runner.py``.  CNN cells train the
paper's models (``models/cnn.py``) on the synthetic CIFAR stream with the
paper's SGD-momentum recipe (``optim.sgdm_update``, lr ``cell.lr``).  LM
cells train the smoke configs of the assigned architectures
(``models/lm.py``: dense transformer / Mamba2 SSD / MoE) on the synthetic
Markov token stream with AdamW at lr 1e-3.  Step ``i`` rounds
stochastically from ``fold_in(1, i)`` on the port's own streams (the JAX
runner's ``fold_in(key(1), i)``; threefry is not reproduced).  A
``"pallas"`` cell runs the quantized-domain kernels (the port's
``QuantConfig(backend="quantized")``: K1/K2/K3 on the card, their plain
versions on the CPU).

Everything is seeded from the cell, and cuDNN runs its deterministic
algorithms, so a cell's metrics are deterministic on one software stack.  :func:`train_cell` takes the initial model and the
batch stream when given (the cross-tests feed the JAX package's weights
and batches), else builds both from the cell's seed on ``device`` (CUDA
unless the caller asks for the CPU).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from collections.abc import Iterable

import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig, get_smoke_config
from repro_torch.core.lowbit import QuantConfig, fold_in
from repro_torch.data import CifarIterator, make_lm_iterator
from repro_torch.kernels import launch_counts
from repro_torch.models import lm
from repro_torch.models.cnn import CNNConfig, init_cnn
from repro_torch.optim import adamw_init, adamw_update, sgdm_init, sgdm_update
from repro_torch.runtime import resolve_device

from .grid import LM_ARCHS, Cell

__all__ = ["ROUNDING_SEED", "Trajectory", "cell_cnn_config", "cell_model_config", "cell_qcfg",
           "cell_row", "divergence_threshold", "run_cell", "run_cells", "train_cell"]

_LM_LR = 1e-3
_NUM_CLASSES = 10
ROUNDING_SEED = 1  # step i rounds from fold_in(ROUNDING_SEED, i)
# a cell's backend -> the port's QuantConfig.backend
_BACKENDS = {"pallas": "quantized", "fake_quant": "fake_quant"}

# A proxy has diverged when its trailing loss exceeds this multiple of the
# uniform-prediction loss (ln(classes) / ln(vocab)) -- or goes non-finite.
_DIVERGENCE_MULT = 2.0


@dataclasses.dataclass
class Trajectory:
    """Per-step record of one cell's run: loss, accuracy (CNN cells; None
    for LM cells), host-clock step seconds (each step ends in a read of its
    loss, so the device has finished it), and each kernel's launches."""

    losses: list[float] = dataclasses.field(default_factory=list)
    accs: list[float] | None = None
    step_s: list[float] = dataclasses.field(default_factory=list)
    launches: list[dict[str, int]] = dataclasses.field(default_factory=list)


def _tail_mean(xs: list[float]) -> float:
    k = max(1, len(xs) // 5)
    return sum(xs[-k:]) / k


def cell_cnn_config(cell: Cell) -> CNNConfig:
    return CNNConfig(arch=cell.arch, num_classes=_NUM_CLASSES, width_mult=cell.width,
                     in_hw=cell.hw)


def cell_qcfg(cell: Cell) -> QuantConfig | None:
    """A CNN cell's quantization (None for fp32): the paper's defaults
    (k_block 128, stochastic rounding) with the cell's format, grouping and
    backend."""
    if cell.emformat is None:
        return None
    return QuantConfig(fmt=cell.emformat, grouping=cell.grouping,
                       backend=_BACKENDS[cell.backend])


def cell_model_config(cell: Cell) -> ModelConfig:
    """An LM cell's smoke config with the cell's numerics (``quant_backend``
    keeps the JAX name; ``ModelConfig.qcfg`` maps "pallas" to "quantized")."""
    cfg = get_smoke_config(LM_ARCHS[cell.arch])
    return dataclasses.replace(
        cfg,
        quant=cell.emformat is not None,
        fmt=cell.emformat if cell.emformat is not None else cfg.fmt,
        quant_backend=cell.backend,
    )


def _step_timed(traj: Trajectory, step, i: int) -> None:
    before = launch_counts()
    t0 = time.perf_counter()
    step(i)
    traj.step_s.append(time.perf_counter() - t0)
    traj.launches.append({k: v - before[k] for k, v in launch_counts().items()})


def _grads(params: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    return {k: p.grad if p.grad is not None else torch.zeros_like(p) for k, p in params.items()}


def _train_cnn(cell: Cell, device, model, batches: Iterable[dict] | None,
               rounding_seed: int | None) -> Trajectory:
    qcfg = cell_qcfg(cell)
    model = model if model is not None else init_cnn(cell_cnn_config(cell), cell.seed, device)
    if batches is None:
        batches = CifarIterator(cell.batch, cell.hw, _NUM_CLASSES, seed=cell.seed, device=device)
    params = dict(model.named_parameters())
    opt = sgdm_init(params)
    traj = Trajectory(accs=[])
    data = iter(batches)

    def step(i):
        nonlocal opt
        b = next(data)
        for p in params.values():
            p.grad = None
        logits = model(b["image"], qcfg, fold_in(rounding_seed, i))
        loss = F.cross_entropy(logits, b["label"])
        loss.backward()
        opt = sgdm_update(_grads(params), opt, params, lr=cell.lr)
        acc = (logits.argmax(-1) == b["label"]).float().mean()
        traj.losses.append(float(loss.detach()))
        traj.accs.append(float(acc))

    for i in range(cell.steps):
        _step_timed(traj, step, i)
    return traj


def _train_lm(cell: Cell, device, model, batches: Iterable[dict] | None,
              rounding_seed: int | None) -> Trajectory:
    cfg = cell_model_config(cell)
    model = model if model is not None else lm.init_lm(cfg, cell.seed, device)
    if batches is None:
        extras = ()
        if cfg.frontend != "none" and cfg.family != "encdec":
            extras = (("frontend_emb", (cell.batch, cfg.frontend_len, cfg.frontend_dim)),)
        batches = make_lm_iterator(cell.batch, cell.seq, cfg.vocab, seed=cell.seed,
                                   extras=extras, device=device)
    params = dict(model.named_parameters())
    opt = adamw_init(params)
    traj = Trajectory()
    data = iter(batches)

    def step(i):
        nonlocal opt
        b = next(data)
        for p in params.values():
            p.grad = None
        loss, _ = lm.lm_loss(model, b, fold_in(rounding_seed, i))
        loss.backward()
        opt = adamw_update(_grads(params), opt, params, lr=_LM_LR)
        traj.losses.append(float(loss.detach()))

    for i in range(cell.steps):
        _step_timed(traj, step, i)
    return traj


def train_cell(cell: Cell, device: str | torch.device = "cuda", *,
               model: torch.nn.Module | None = None, batches: Iterable[dict] | None = None,
               rounding_seed: int | None = ROUNDING_SEED) -> Trajectory:
    """Train one cell for ``cell.steps`` steps on ``device``.  ``model``
    (updated in place) and ``batches`` (an iterable of batch dicts on the
    device) default to the cell's seed; ``rounding_seed=None`` rounds to
    nearest."""
    device = resolve_device(device)
    train = _train_cnn if cell.is_cnn else _train_lm
    with _deterministic_cudnn():
        return train(cell, device, model, batches, rounding_seed)


@contextlib.contextmanager
def _deterministic_cudnn():
    """cuDNN's deterministic algorithms, restored afterwards: with its
    default choice for the fp32 convs (the stem; every conv on the
    fake-quant backend) a cell on the H100 left its own rerun at step 3."""
    flags = torch.backends.cudnn
    saved = flags.deterministic, flags.benchmark
    flags.deterministic, flags.benchmark = True, False
    try:
        yield
    finally:
        flags.deterministic, flags.benchmark = saved


def divergence_threshold(cell: Cell) -> float:
    if cell.is_cnn:
        return _DIVERGENCE_MULT * math.log(_NUM_CLASSES)
    return _DIVERGENCE_MULT * math.log(get_smoke_config(LM_ARCHS[cell.arch]).vocab)


def cell_row(cell: Cell, traj: Trajectory, wall: float) -> dict:
    """A trained cell's BENCH_accuracy.json row (the JAX runner's schema):
    the tail means (last fifth) of loss and accuracy."""
    final_loss = _tail_mean(traj.losses)
    final_acc = None if traj.accs is None else _tail_mean(traj.accs)
    diverged = (not math.isfinite(final_loss)
                or final_loss > divergence_threshold(cell))
    row = {
        "name": f"sweep/{cell.cell_id()}",
        "cell_id": cell.cell_id(),
        "config_hash": cell.config_hash(),
        "arch": cell.arch,
        "fmt": cell.fmt,
        "backend": cell.backend,
        "grouping": cell.grouping,
        "steps": cell.steps,
        "final_loss": round(final_loss, 6) if math.isfinite(final_loss) else None,
        "final_acc": None if final_acc is None else round(final_acc, 6),
        "diverged": bool(diverged),
        "wall_time_s": round(wall, 2),
    }
    if cell.envelope_acc is not None:
        row["envelope_acc"] = cell.envelope_acc
    if cell.envelope_loss is not None:
        row["envelope_loss"] = cell.envelope_loss
    return row


def run_cell(cell: Cell, device: str | torch.device = "cuda", **train_kw) -> dict:
    """Train one cell (:func:`train_cell`); return its BENCH_accuracy.json row."""
    t0 = time.perf_counter()
    traj = train_cell(cell, device, **train_kw)
    return cell_row(cell, traj, time.perf_counter() - t0)


def run_cells(cells: list[Cell], device: str | torch.device = "cuda",
              verbose: bool = True) -> list[dict]:
    rows = []
    for i, cell in enumerate(cells):
        row = run_cell(cell, device)
        rows.append(row)
        if verbose:
            loss = row["final_loss"]
            acc = row["final_acc"]
            print(f"[{i + 1}/{len(cells)}] {row['cell_id']}: "
                  f"loss={'nan' if loss is None else f'{loss:.3f}'}"
                  + ("" if acc is None else f" acc={acc:.3f}")
                  + (" DIVERGED" if row["diverged"] else "")
                  + f" ({row['wall_time_s']:.1f}s)", flush=True)
    return rows
