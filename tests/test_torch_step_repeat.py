"""The step-repeat check of chip_smoke.py's tune phase on the CPU: the
report of differing tensors, and the script's refusal without a card."""
import importlib.util
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


def _step(loss: float, grads: list[list[float]]) -> dict:
    return dict(loss=torch.tensor(loss), grads=[torch.tensor(g) for g in grads],
                names=tuple(f"p{i}" for i in range(len(grads))))


def test_step_differences_names_each_differing_tensor():
    a = _step(2.5, [[1.0, 2.0, 3.0], [4.0]])
    assert chip_smoke.step_differences(a, _step(2.5, [[1.0, 2.0, 3.0], [4.0]])) == []
    got = chip_smoke.step_differences(a, _step(2.5, [[1.0, 2.5, 3.25], [4.0]]))
    assert got == ["p0: 2 of 3 differ, max |d| 0.5"]
    got = chip_smoke.step_differences(a, _step(2.0, [[1.0, 2.0, 3.0], [-4.0]]))
    assert got == ["loss: 1 of 1 differ, max |d| 0.5", "p1: 1 of 1 differ, max |d| 8"]


def test_step_differences_compares_as_torch_equal():
    nan = float("nan")
    # as torch.equal: a NaN differs from itself, -0.0 equals 0.0
    assert chip_smoke.step_differences(_step(nan, [[0.0]]), _step(nan, [[0.0]]))[0].startswith(
        "loss: 1 of 1 differ")
    assert chip_smoke.step_differences(_step(1.0, [[0.0]]), _step(1.0, [[-0.0]])) == []


def test_step_repeat_script_raises_without_a_gpu(monkeypatch):
    spec = importlib.util.spec_from_file_location(
        "torch_step_repeat", ROOT / "benchmarks" / "torch_step_repeat.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        mod.main(["--pairs", "1"])
