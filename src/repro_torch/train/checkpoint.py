"""Atomic, asynchronous checkpoints with restore onto any device.

Layout (one directory per step)::

    <dir>/step_000123/
        tensors.pt    -- the state's tensors, by path (``torch.save``)
        index.json    -- the tree's paths, and its non-tensor leaves
    <dir>/step_000123.done  -- commit marker

* **Atomicity** -- a writer fills ``step_*.tmp`` and renames it; readers
  trust only a step with a ``.done`` marker, so a writer that dies midway
  never corrupts the latest checkpoint.
* **Async** -- ``save(..., blocking=False)`` copies every tensor to host
  memory synchronously (a consistent cut of the training state) and writes
  the files on a thread, so the training loop keeps stepping.
* **Restore onto any device** -- ``restore(template, step, device)``
  rebuilds the template's structure with the saved values and puts the
  tensors on ``device``: a state saved on the card restores on the CPU or
  on the card (the port's form of the JAX package's reshard on restore).
* **Keep-k GC**; the state may hold the data iterator's step and the
  step's rounding key, so a resumed run repeats the uninterrupted one.

A state is a tree of dicts (any keys that print uniquely, such as an
optimizer's integer keys), lists, tuples and named tuples (an LM
optimizer's ``OptState``) whose leaves are tensors or JSON values (ints,
floats, strings, bools, ``None``).
"""
from __future__ import annotations

import contextlib
import json
import os
import shutil
import threading
from collections.abc import Mapping
from typing import Any

import torch

__all__ = ["CheckpointManager"]


def _flatten(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """``(path, leaf)`` of every leaf, in the tree's order."""
    if isinstance(tree, Mapping):
        return [kv for k, v in tree.items() for kv in _flatten(v, f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree) for kv in _flatten(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(template: Any, leaves: dict[str, Any], prefix: str = "") -> Any:
    """The template's structure with the leaves at its paths."""
    if isinstance(template, Mapping):
        return type(template)((k, _unflatten(v, leaves, f"{prefix}[{k!r}]"))
                              for k, v in template.items())
    if isinstance(template, (list, tuple)):
        items = [_unflatten(v, leaves, f"{prefix}[{i}]") for i, v in enumerate(template)]
        if hasattr(template, "_fields"):  # a NamedTuple, such as an OptState
            return type(template)(*items)
        return type(template)(items)
    return leaves[prefix]


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = str(directory)
        self.keep = keep
        os.makedirs(self.dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    # ---------------- save ----------------
    def save(self, step: int, state: Any, blocking: bool = True) -> None:
        """Snapshot ``state`` at ``step``: its tensors are copied to host
        memory before this returns; the files are written on a thread
        unless ``blocking``."""
        self.wait()  # one save in flight at a time
        tensors, values = {}, {}
        for path, leaf in _flatten(state):
            if isinstance(leaf, torch.Tensor):
                tensors[path] = leaf.detach().to("cpu", copy=True)
            else:
                values[path] = leaf
        index = {"step": step, "tensors": list(tensors), "values": values}

        def write() -> None:
            name = f"step_{step:08d}"
            tmp = os.path.join(self.dir, name + ".tmp")
            final = os.path.join(self.dir, name)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(tensors, os.path.join(tmp, "tensors.pt"))
            with open(os.path.join(tmp, "index.json"), "w") as f:
                json.dump(index, f)
            shutil.rmtree(final, ignore_errors=True)
            os.rename(tmp, final)
            with open(final + ".done", "w") as f:
                f.write("ok")
            self._gc()

        if blocking:
            write()
            return

        def run() -> None:
            try:
                write()
            except BaseException as e:  # handed to the caller by wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Wait for the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------- restore ----------------
    def latest_step(self) -> int | None:
        steps = [int(f[len("step_"):-len(".done")]) for f in os.listdir(self.dir)
                 if f.endswith(".done")]
        return max(steps) if steps else None

    def restore(self, template: Any, step: int | None = None,
                device: str | torch.device | None = None) -> Any:
        """The state saved at ``step`` (default: the latest), in the
        structure of ``template``.  Tensors go to ``device``, or where the
        template's tensor at the same path lies (a non-tensor leaf there,
        such as a momentum buffer not made yet: the CPU)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "index.json")) as f:
            index = json.load(f)
        tensors = torch.load(os.path.join(path, "tensors.pt"), map_location="cpu",
                             weights_only=True)
        leaves = dict(index["values"])
        for p, leaf in _flatten(template):
            if p in tensors:  # where the template has no tensor: the CPU
                here = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
                leaves[p] = tensors[p].to(device if device is not None else here)
        missing = [p for p, _ in _flatten(template) if p not in leaves]
        if missing:
            raise KeyError(f"checkpoint step {step} has no leaf at {missing[:3]}")
        return _unflatten(template, leaves)

    # ---------------- gc ----------------
    def _gc(self) -> None:
        done = sorted(int(f[len("step_"):-len(".done")])
                      for f in os.listdir(self.dir) if f.endswith(".done"))
        for s in done[: max(0, len(done) - self.keep)]:
            name = os.path.join(self.dir, f"step_{s:08d}")
            shutil.rmtree(name, ignore_errors=True)
            with contextlib.suppress(OSError):
                os.remove(name + ".done")
