"""The dry run's extension (``repro_torch.launch.dryrun.trace_cell``): a
deep cell's counts carried from traces at two and three depth units, and
at two and three microbatches, equal a whole trace of the cell, exactly:
dot FLOPs by dtype, wire bytes by op and mesh dim, collective counts,
argument and output bytes, K1/K3 launches, and the peak by kind.

Every LM family's smoke config, widened for a model axis
(``launch.train.tp_smoke``), in the launcher's layout under a fake world
of 4 (data 2 x model 2), traced at 4 depth units (a unit: a layer, a
hybrid segment with its shared-block use, an encoder and a decoder layer)
with extension forced past 3 (``WHOLE_UP_TO``; the production default is
5, where the extension costs less than a whole trace); the microbatch
extension at 4 microbatches on the dense family, and on the quantized
backend (K1/K3's shape-only path) with both at once.  Serving, every
family's decode step against a full cache (and its cache bytes), and the
dense and hybrid families' prefill, extended in depth alike: the counts
exactly, the bytes held by the allocator's blocks within one block (512
B) per stacked cache tensor, whose rounding is not linear in the depth
(the Mamba2 conv state's (L, B, K-1, C) is not whole blocks a layer).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.train import tp_smoke  # noqa: E402
from repro_torch.models import lm  # noqa: E402

FAMILIES = {"dense": "chatglm3-6b", "ssm": "mamba2-370m", "hybrid": "zamba2-7b",
            "moe": "moonshot-v1-16b-a3b", "encdec": "seamless-m4t-medium"}
KEYS = ("hlo", "argument_bytes", "output_bytes", "launches", "peak_by_kind", "peak_bytes",
        "cache_bytes")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _extended_and_whole(cfg, units: int, parts: int, monkeypatch, kind: str = "train"):
    monkeypatch.setattr(dryrun, "WHOLE_UP_TO", 3)
    cfg = dryrun.depth_units(cfg)[1](units)
    with dryrun.fake_world(4):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        ext = dryrun.trace_cell(cfg, 2 * parts, 32, parts, mesh, extend=True, kind=kind)
        whole = dryrun.trace_cell(cfg, 2 * parts, 32, parts, mesh, extend=False, kind=kind)
    return cfg, ext, whole


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_depth_extension_equals_a_whole_trace(family, monkeypatch):
    cfg, ext, whole = _extended_and_whole(tp_smoke(configs.get_smoke_config(FAMILIES[family])),
                                          4, 1, monkeypatch)
    at = dryrun.depth_units(cfg)[1]
    assert ext["extended"] and ext["traced"] == [[at(2).n_layers, 1], [at(3).n_layers, 1]]
    assert whole["traced"] == [[cfg.n_layers, 1]] and not whole["extended"]
    for k in KEYS:
        assert ext[k] == whole[k], (family, k, ext[k], whole[k])


@pytest.mark.parametrize("backend", ["fake_quant", "pallas"])
def test_microbatch_extension_equals_a_whole_trace(backend, monkeypatch):
    cfg = dataclasses.replace(tp_smoke(configs.get_smoke_config("chatglm3-6b")),
                              quant_backend=backend)
    units = 1 if backend == "fake_quant" else 4
    cfg, ext, whole = _extended_and_whole(cfg, units, 4, monkeypatch)
    assert [m for _, m in ext["traced"]][-2:] == [2, 3]
    for k in KEYS:
        assert ext[k] == whole[k], (backend, k, ext[k], whole[k])
    if backend == "pallas":  # K1's split entries and one-call entry, K3: the card's
        assert set(whole["launches"]) == {"mls_quantize_rows", "mls_quantize_rows_amax",
                                          "mls_quantize_rows_codes", "mls_matmul"}
        assert whole["hlo"]["dot_flops_by_dtype"]["u8"] > 0


SERVE = [(f, "decode") for f in sorted(FAMILIES)] + [("dense", "prefill"), ("hybrid", "prefill")]


@pytest.mark.parametrize("family,kind", SERVE)
def test_serve_depth_extension_equals_a_whole_trace(family, kind, monkeypatch):
    cfg, ext, whole = _extended_and_whole(tp_smoke(configs.get_smoke_config(FAMILIES[family])),
                                          4, 1, monkeypatch, kind)
    assert ext["extended"] and not whole["extended"] and whole["cache_bytes"] > 0
    blocks = 512 * len(lm.cache_spec(cfg, 2, 32))
    for k in KEYS:
        if k in ("argument_bytes", "output_bytes", "peak_bytes"):
            assert abs(ext[k] - whole[k]) < blocks, (family, kind, k, ext[k], whole[k])
        elif k == "peak_by_kind":
            assert ext[k].keys() == whole[k].keys()
            assert all(abs(ext[k][n] - v) < blocks for n, v in whole[k].items()), (ext[k], whole[k])
        else:
            assert ext[k] == whole[k], (family, kind, k, ext[k], whole[k])
