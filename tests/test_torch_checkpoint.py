"""The port's checkpoint manager and straggler monitor
(``repro_torch.train``), mirroring ``tests/test_checkpoint.py``: round
trip, keep-k GC, async save, uncommitted steps ignored, the data stream
resuming; and a training run restored from a checkpoint repeating the
uninterrupted run bit for bit (model, momentum, data step, rounding key).
On the CPU; the card's save-and-restore runs in ``chip_smoke.py``.
"""
import os

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import EMFormat, QuantConfig  # noqa: E402
from repro_torch.data import CifarIterator  # noqa: E402
from repro_torch.models.cnn import CNNConfig  # noqa: E402
from repro_torch.train import CheckpointManager, StragglerMonitor  # noqa: E402
from repro_torch.train import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.train.loop import init_state, train_step  # noqa: E402


def _tree():
    return {
        "w": torch.arange(12.0).reshape(3, 4),
        "nested": {"b": torch.ones(2, dtype=torch.bfloat16), "s": 7, 0: [torch.tensor([1, 2]),
                                                                          None]},
    }


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree) if isinstance(tree, torch.Tensor) else tree


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b)
    else:
        assert a == b


def test_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    mgr.save(5, t)
    assert mgr.latest_step() == 5
    r = mgr.restore(_zeros_like(t), device="cpu")
    _assert_equal(t, r)


def test_keep_k_gc(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in [1, 2, 3, 4]:
        mgr.save(s, _tree())
    done = sorted(f for f in os.listdir(tmp_path) if f.endswith(".done"))
    assert done == ["step_00000003.done", "step_00000004.done"]
    assert sorted(d for d in os.listdir(tmp_path) if not d.endswith(".done")) == [
        "step_00000003", "step_00000004"]


def test_async_save_snapshots_before_returning(tmp_path):
    """The tensors are copied when save returns: changing them afterwards
    does not change the checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=3)
    t = _tree()
    mgr.save(1, t, blocking=False)
    t["w"].add_(100.0)
    mgr.wait()
    assert mgr.latest_step() == 1
    assert torch.equal(mgr.restore(_zeros_like(t))["w"], torch.arange(12.0).reshape(3, 4))


def test_async_save_error_reaches_the_caller(tmp_path, monkeypatch):
    mgr = CheckpointManager(tmp_path)

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_mod.torch, "save", broken)
    mgr.save(1, _tree(), blocking=False)
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_atomicity_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree())
    # a writer that died midway: a directory without its .done marker
    os.makedirs(tmp_path / "step_00000009")
    os.makedirs(tmp_path / "step_00000010.tmp")
    assert mgr.latest_step() == 1
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(_tree())


def test_data_iterator_state_resumes(tmp_path):
    it = CifarIterator(2, 8, device="cpu")
    seen = [next(it)["image"] for _ in range(3)]
    mgr = CheckpointManager(tmp_path)
    mgr.save(3, {"data_step": it.step})
    it2 = CifarIterator(2, 8, device="cpu")
    it2.step = mgr.restore({"data_step": 0})["data_step"]
    assert torch.equal(next(it)["image"], next(it2)["image"])
    assert not torch.equal(seen[0], seen[1])  # the stream is not constant


@pytest.mark.parametrize("backend", ["quantized", "fake_quant"])
def test_resumed_run_repeats_the_uninterrupted_run(tmp_path, backend):
    """Four steps in one run against two, a checkpoint, a fresh process'
    state restored from it, and two more: the same losses, bit for bit
    (stochastic rounding, momentum and the data stream included)."""
    cfg = CNNConfig("resnet20", width_mult=0.25, in_hw=8)
    qcfg = QuantConfig(fmt=EMFormat(2, 1), k_block=32, backend=backend)
    lr = [0.05, 0.05, 0.005, 0.005]
    whole = init_state(cfg, batch=4, seed=2, device="cpu")
    want = [train_step(whole, qcfg, lr[i]) for i in range(4)]
    first = init_state(cfg, batch=4, seed=2, device="cpu")
    got = [train_step(first, qcfg, lr[i]) for i in range(2)]
    mgr = CheckpointManager(tmp_path)
    mgr.save(first.step, first.state_dict(), blocking=False)
    mgr.wait()
    resumed = init_state(cfg, batch=4, seed=2, device="cpu")
    resumed.load_state_dict(mgr.restore(resumed.state_dict(), device="cpu"))
    assert (resumed.step, resumed.data.step) == (2, 2)
    got += [train_step(resumed, qcfg, lr[i]) for i in range(2, 4)]
    assert got == want
    for (n, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n


def test_straggler_monitor_flags_slow_steps(monkeypatch):
    clock = iter([0.0, 1.0, 1.0, 2.0, 2.0, 3.0, 3.0, 4.0, 4.0, 5.0, 5.0, 9.0, 9.0, 10.0])
    monkeypatch.setattr("repro_torch.train.straggler.time.perf_counter", lambda: next(clock))
    mon = StragglerMonitor(warmup_steps=3)
    dts = []
    for _ in range(7):
        mon.start()
        dts.append(mon.stop())
    assert dts == [1.0, 1.0, 1.0, 1.0, 1.0, 4.0, 1.0]
    assert mon.report()["straggler_steps"] == [6]
    assert mon.report()["steps"] == 7


def test_one_save_in_flight(tmp_path):
    """A second save waits for the first: both steps end committed."""
    mgr = CheckpointManager(tmp_path, keep=5)
    mgr.save(1, _tree(), blocking=False)
    mgr.save(2, _tree(), blocking=False)
    mgr.wait()
    assert sorted(f for f in os.listdir(tmp_path) if f.endswith(".done")) == [
        "step_00000001.done", "step_00000002.done"]
