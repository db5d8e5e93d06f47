"""Straggler / step-time monitoring.

Every rank of a data-parallel job runs the same step, so one slow rank
stalls the whole step (the collectives are synchronous).  Mitigation at
scale is detection plus preempt and restart from a checkpoint (which
:class:`~repro_torch.train.checkpoint.CheckpointManager` makes cheap); this
module provides the detection: an EMA step timer that flags steps (or,
with per-rank times fed in from an out-of-band channel, ranks) exceeding
``threshold`` x the EMA.  The step time is the host clock between
:meth:`StragglerMonitor.start` and :meth:`StragglerMonitor.stop`; the
caller ends the step with a device sync.
"""
from __future__ import annotations

import dataclasses
import time

__all__ = ["StragglerMonitor"]


@dataclasses.dataclass
class StragglerMonitor:
    ema_decay: float = 0.9
    threshold: float = 2.0  # flag if step_time > threshold * ema
    warmup_steps: int = 3  # ignore the first steps (kernel builds, allocator warm-up)
    ema: float | None = None
    steps: int = 0
    flagged: list[int] = dataclasses.field(default_factory=list)
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        dt = time.perf_counter() - self._t0
        self.steps += 1
        if self.steps <= self.warmup_steps:
            return dt
        if self.ema is None:
            self.ema = dt
        if dt > self.threshold * self.ema:
            self.flagged.append(self.steps)
        self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * dt
        return dt

    def report(self) -> dict:
        return {
            "steps": self.steps,
            "ema_step_time_s": self.ema,
            "straggler_steps": list(self.flagged),
        }
