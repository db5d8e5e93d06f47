"""Hygiene of the PyTorch port: it imports nothing of JAX or of the JAX
package, runs on CUDA unless asked for the CPU, builds its kernels only
when first launched, and its chip smoke test refuses to run without a GPU
or without the repository beside it."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted(ROOT.glob("examples/torch_*.py"))
              + sorted(ROOT.glob("benchmarks/torch_*.py")))
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax_and_no_reference_package(path):
    assert not (_imported_roots(path) & FORBIDDEN), path


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.kernels, repro_torch.models.cnn, "
            "repro_torch.train.loop, repro_torch.convert, repro_torch.kernels.registry, "
            "repro_torch.kernels.sabotage, repro_torch.analysis.audit, "
            "repro_torch.analysis.kernel_verify, repro_torch.analysis.graphs, "
            "repro_torch.energy, repro_torch.train, repro_torch.core.quantize, "
            "repro_torch.configs, repro_torch.models.lm, repro_torch.serve, "
            "repro_torch.train.trainer, repro_torch.launch.train, repro_torch.optim, "
            "repro_torch.data, repro_torch.sweep, repro_torch.sweep.__main__, "
            "repro_torch.sweep.grid, repro_torch.sweep.runner, repro_torch.sweep.gate, "
            "repro_torch.sweep.report, repro_torch.sweep.record; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(), timeout=120)


def test_entry_points_default_to_cuda_and_raise_without_a_gpu(monkeypatch):
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import CifarIterator, cifar_like_batch, make_lm_iterator
    from repro_torch.launch import train
    from repro_torch.models.cnn import CNNConfig, init_cnn
    from repro_torch.models.lm import init_lm
    from repro_torch.runtime import resolve_device
    from repro_torch.serve import ServeEngine
    from repro_torch.train import loop

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        loop.main(["--steps", "1", "--width", "0.25", "--hw", "8", "--batch", "2"])
    with pytest.raises(RuntimeError, match="no GPU"):
        init_cnn(CNNConfig(width_mult=0.25, in_hw=8))
    with pytest.raises(RuntimeError, match="no GPU"):
        CifarIterator(2, 8)
    with pytest.raises(RuntimeError, match="no GPU"):
        cifar_like_batch(torch.Generator().manual_seed(0), 2, 8)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    cfg = get_smoke_config("qwen2-72b")
    with pytest.raises(RuntimeError, match="no GPU"):
        init_lm(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        ServeEngine(cfg, init_lm(cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="no GPU"):
        make_lm_iterator(2, 8, cfg.vocab)
    with pytest.raises(RuntimeError, match="no GPU"):
        train.main(["--arch", "qwen2-72b", "--smoke", "--steps", "1"])
    from repro_torch.sweep import __main__ as sweep_cli

    with pytest.raises(RuntimeError, match="no GPU"):
        sweep_cli.main(["--smoke", "--only", "resnet20/fp32/fake_quant"])


def test_quantized_config_refusals():
    from repro_torch.core import EMFormat, QuantConfig

    assert QuantConfig(backend="fake_quant").backend == "fake_quant"
    with pytest.raises(ValueError, match="backend"):
        QuantConfig(backend="pallas")
    assert QuantConfig(conv_impl="implicit").conv_impl == "implicit"
    with pytest.raises(ValueError, match="conv_impl"):
        QuantConfig(conv_impl="winograd")
    with pytest.raises(ValueError, match=">= 24"):
        QuantConfig(fmt=EMFormat(3, 4), k_block=128)
    with pytest.raises(ValueError):
        QuantConfig(grouping="rows")
    assert QuantConfig().backend == "quantized"


def test_kernel_build_is_lazy_and_exact():
    """No library is built at import; the flags keep IEEE arithmetic and the
    Hopper target; without nvcc the build raises instead of falling back."""
    from repro_torch.kernels import build

    assert build._lib is None
    flags = " ".join(build.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags and "-fmad=false" in flags
    assert "fast_math" not in flags
    assert {p.name for p in build.CSRC.iterdir()} >= {
        "mls_common.cuh", "mls_mma.cuh", "mls_quantize.cu", "mls_matmul.cu", "implicit_conv.cu",
        "sabotage_overlap.cu"}
    assert build.library_path().name.startswith("libmls_kernels_")
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.library()


def test_kernel_build_dir_is_the_checkout_or_the_user_cache(tmp_path, monkeypatch):
    """From the source tree the library goes to the checkout's build/; an
    installed package builds into the user's cache, never beside itself."""
    from repro_torch.kernels import build

    root = Path(__file__).resolve().parents[1]
    assert build.build_dir() == root / "build" / "kernels"
    assert build.library_path().parent == root / "build" / "kernels"
    installed = tmp_path / "lib" / "python3" / "site-packages" / "repro_torch"
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build.build_dir(installed) == tmp_path / "cache" / "repro_torch" / "kernels"
    monkeypatch.delenv("XDG_CACHE_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    assert build.build_dir(installed) == tmp_path / "home" / ".cache" / "repro_torch" / "kernels"


def test_chip_smoke_fails_without_a_gpu_and_alone(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run for real")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, env=_env(), timeout=300)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
