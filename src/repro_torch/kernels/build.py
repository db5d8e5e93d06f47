"""Build and bind the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` (one process per source, all
started together) for ``sm_90a`` and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build happens at first use,
into ``build/kernels/`` of the checkout (or, for an installed package, the
user's cache directory: see :func:`build_dir`), under a name keyed by a
hash of the sources and flags, so an edited source rebuilds and an unchanged one
loads at once.  Nothing here runs when the module is imported.

``-fmad=false`` keeps every ``a*b + c`` as two roundings, as in the plain
PyTorch versions; fast math is never used (IEEE division, no
flush-to-zero).  Each C entry point returns ``cudaGetLastError()`` and
:func:`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["CSRC", "NVCC_FLAGS", "build_dir", "check", "library", "library_path"]

PACKAGE = Path(__file__).resolve().parents[1]  # .../repro_torch
CSRC = PACKAGE / "kernels" / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
_SIGNATURES = {
    # x, r_u8, partials, n_partials, s_t, codes, s_g, M, K, group_width,
    # e, m, e_min, gs_m, gs_emin, stream
    "mls_quantize_rows": [_P, _P, _P, _I, _P, _P, _P, _LL, _LL, _I, _I, _I, _I, _I, _I, _P],
    # x, r_u8, part, n_part, gmax, s_t, codes, s_g, M, K, group_width, vec,
    # e, m, e_min, gs_m, gs_emin, stream
    "mls_quantize_cols": [_P, _P, _P, _LL, _P, _P, _P, _P, _LL, *[_I] * 8, _P],
    # x, r_u8, s_t, s_g, codes, M, K, k_block, sg_stride, vec,
    # e, m, e_min, gs_m, gs_emin, stream
    "mls_quantize_given_sg": [_P, _P, _P, _P, _P, _LL, *[_I] * 9, _P],
    # xc, sxm, sxk, xsg, sxsg_m, sxsg_g, wc, swk, swn, wsg, swsg_g, swsg_n,
    # xst, wst, unit, out, terms, M, N, K, k_block, e, m, bn, body, split, stream
    "mls_matmul": [_P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL, _P, _LL, _LL,
                   _P, _P, ctypes.c_float, _P, _P, *[_I] * 9, _P],
    # x, r_u8, scratch, n_scratch, wc, swk, swn, wsg, swsg_g, swsg_n, wst,
    # unit, out, n, c, h, w, o, kh, kw, sh, sw, ph, pw, hp, wp, k_block, mode,
    # e, m, e_min, gs_m, gs_emin, stream
    "implicit_conv": [_P, _P, _P, _LL, _P, _LL, _LL, _P, _LL, _LL,
                      _P, ctypes.c_float, _P, *[_I] * 15, *[_I] * 5, _P],
    # x, partials, n_partials, s_t, n, c, h, w, kh, kw, sh, sw, ph, pw, hp, wp, stream
    "conv_tensor_scale": [_P, _P, _I, _P, *[_I] * 12, _P],
    # x, w, out, probe (or NULL), M, K, N, stream
    "sabotage_overlap": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mls_error_string": [_I],
    # each source's tile constants: out, n -> how many it has
    "mls_quantize_constants": [_P, _I],
    "mls_matmul_constants": [_P, _I],
    "implicit_conv_constants": [_P, _I],
    "sabotage_overlap_constants": [_P, _I],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not Path(nvcc).exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                           "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return nvcc


def build_dir(package: Path = PACKAGE) -> Path:
    """Where the library is built: ``build/kernels/`` of the checkout when
    the package runs from its source tree (``<root>/src/repro_torch`` beside
    ``<root>/pyproject.toml``), else ``$XDG_CACHE_HOME/repro_torch/kernels``
    (``~/.cache`` by default), never a directory beside an installed
    package."""
    root = package.parents[1]
    if package.parent.name == "src" and (root / "pyproject.toml").is_file():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or Path.home() / ".cache"
    return Path(cache) / "repro_torch" / "kernels"


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode() + p.read_bytes())
    return build_dir() / f"libmls_kernels_{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    nvcc = _nvcc()
    work = out.with_suffix(f".{os.getpid()}.tmp")
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():  # one nvcc per source, all at once
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    outputs = [(src, p.communicate()[0], p.returncode) for src, _, p in procs]
    for src, text, rc in outputs:  # all compilers have exited by now
        if rc:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
    log = [f"== {src.name} ==\n{text}" for src, text, _ in outputs]
    tmp_so = work / out.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_so), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    out.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp_so, out)  # atomic: a concurrent build sees all or nothing
    shutil.rmtree(work, ignore_errors=True)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, args in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.mls_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().mls_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {rc} ({msg})")
