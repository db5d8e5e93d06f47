"""The port's tile cache and tuner (``repro_torch.kernels.autotune``).

- Keys: every registry spec's key letter for letter the JAX registry's,
  and the conv dims of ResNet-20's convs equal to JAX's
  ``conv_tune_dims``.
- The cache: save, load and merge; a corrupt file, a wrong version, a
  malformed entry and a cache of another card each give a load warning,
  never a crash, and resolution then takes the defaults.
- Resolution: explicit > cache hit for this card > default, memoized;
  ``resolve_conv_impl``'s order against JAX's on the same cache contents
  (JAX's cache through ``REPRO_TUNE_CACHE``, the port's through
  ``override_cache``, with the port's card name patched in: on the CPU no
  cache applies).  A cached choice the kernel cannot run raises.
- The wrappers under a cache: the launches recorded are the cached
  choices', every one proven, and the numbers the default's bit for bit.
- Candidates: every one proven on CPU descriptors; illegal ones (a warp
  per group above 1024, a split over the workspace limit, K4 where its
  band does not fit) absent and refused by the verifier.
- ``tune`` with an injected timer, ``check_cache`` on the committed seed
  and on broken caches, the CLI's exit codes, the audit's gate on a stale
  cache.
- The bytes models: terms summing to their total, the implicit route at
  least 3x below im2col at ResNet-20's stage-1 conv.
- ``benchmarks/torch_kernel_bench.py --device cpu --small``.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core.formats import EMFormat as JEMFormat  # noqa: E402
from repro.core.lowbit import QuantConfig as JQuantConfig  # noqa: E402
from repro.kernels import autotune as jat  # noqa: E402
from repro.kernels import implicit_conv as jic  # noqa: E402
from repro.kernels.registry import KERNEL_REGISTRY as JREGISTRY  # noqa: E402
from repro_torch.analysis import audit  # noqa: E402
from repro_torch.core import FMT_IMAGENET, QuantConfig  # noqa: E402
from repro_torch.kernels import autotune as at  # noqa: E402
from repro_torch.kernels import implicit_conv as ic  # noqa: E402
from repro_torch.kernels import launch, lowbit_conv_fused, qd_gemm, recorded_specs  # noqa: E402
from repro_torch.kernels import reset_launch_counts  # noqa: E402
from repro_torch.kernels.mls_matmul import tuned_plan  # noqa: E402
from repro_torch.kernels.registry import KERNEL_REGISTRY  # noqa: E402
from repro_torch.analysis.kernel_verify import verify_specs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CARD = "NVIDIA H100 80GB HBM3"
F = FMT_IMAGENET

RESNET_CONVS = [  # (x, w, stride): full-width ResNet-20's quantized conv geometries
    ((128, 16, 32, 32), (16, 16, 3, 3), 1), ((128, 16, 32, 32), (32, 16, 3, 3), 2),
    ((128, 16, 32, 32), (32, 16, 1, 1), 2), ((128, 32, 16, 16), (32, 32, 3, 3), 1),
    ((128, 32, 16, 16), (64, 32, 3, 3), 2), ((128, 32, 16, 16), (64, 32, 1, 1), 2),
    ((128, 64, 8, 8), (64, 64, 3, 3), 1)]


@pytest.fixture(autouse=True)
def _fresh_cache(monkeypatch, tmp_path):
    """Every test starts from a process cache that holds nothing local."""
    monkeypatch.setenv(at.CACHE_ENV_VAR, str(tmp_path / "none.json"))
    at.invalidate_cache()
    yield
    at.invalidate_cache()


@pytest.fixture
def on_card(monkeypatch):
    """Resolution as on the card named CARD (the tensors stay on the CPU)."""
    monkeypatch.setattr(at, "device_name", lambda device=None: CARD)
    at.invalidate_cache()


def _cache(*entries, device=CARD) -> at.TuneCache:
    c = at.TuneCache(device=device)
    for spec, config in entries:
        c.put(spec, config, 1.0)
    return c


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------
def test_registry_specs_key_as_jax():
    ours = {name: e.tune for name, e in KERNEL_REGISTRY.items()}
    # the port names JAX's *_pallas wrappers without the suffix
    theirs = {name.removesuffix("_pallas"): e.tune for name, e in JREGISTRY.items()}
    assert set(ours) == set(theirs)
    for name, spec in ours.items():
        assert (spec is None) == (theirs[name] is None), name
        if spec is not None:
            assert spec.key() == theirs[name].key(), name
            assert spec.k_block == theirs[name].k_block and spec.grouping == theirs[name].grouping
    assert [s.key() for s in at.registry_specs()] == [s.key() for s in jat.registry_specs()]


@pytest.mark.parametrize("kb", [128, 144])
def test_conv_dims_and_keys_match_jax(kb):
    for xs, ws, s in RESNET_CONVS:
        g = ic.conv_geometry(xs, ws, (s, s), "SAME")
        jg = jic.conv_geometry(xs, ws, (s, s), "SAME")
        assert ic.conv_tune_dims(g, kb) == jic.conv_tune_dims(jg, kb)
        ours = at.TuneSpec("conv", ic.conv_tune_dims(g, kb), F, kb)
        theirs = jat.TuneSpec("conv", jic.conv_tune_dims(jg, kb), JEMFormat(2, 4), kb)
        assert ours.key() == theirs.key() == at.cache_key("conv", ours.shape, F, "nc")


def test_spec_round_trips_and_refuses_bad_shapes():
    spec = at.TuneSpec("gemm", (3, 256, 5), F, 128, "c")
    assert at.TuneSpec.from_json(json.loads(json.dumps(spec.to_json()))) == spec
    cfg = at.BlockConfig("split", 32)
    assert at.BlockConfig.from_json(json.loads(json.dumps(cfg.to_json()))) == cfg
    for bad in (dict(kind="gemm", shape=(1, 2)), dict(kind="conv", shape=(1,) * 13 + (9,),
                                                      k_block=8), dict(kind="dot", shape=(1,))):
        with pytest.raises(ValueError):
            at.TuneSpec(fmt=F, **bad)
    for bad in (dict(variant="tile"), dict(variant="walk", bn=48),
                dict(variant="warp", amax_blocks=-1)):
        with pytest.raises(ValueError):
            at.BlockConfig(**bad)


# ---------------------------------------------------------------------------
# the cache file
# ---------------------------------------------------------------------------
def test_cache_save_load_merge(tmp_path):
    a = at.TuneSpec("gemm", (4, 256, 8), F)
    b = at.TuneSpec("quantize", (4, 256), F)
    c1 = _cache((a, at.BlockConfig("split", 16)))
    p = c1.save(tmp_path / "c.json")
    loaded = at.TuneCache.load(p)
    assert loaded.device == CARD and not loaded.load_warnings
    assert loaded.get(a.key()) == at.BlockConfig("split", 16) and loaded.get(b.key()) is None
    over = _cache((a, at.BlockConfig("walk", 16)), (b, at.BlockConfig("block", 0, 1)))
    merged = over.merged_over(loaded)
    assert merged.get(a.key()) == at.BlockConfig("walk", 16) and len(merged) == 2
    assert at.TuneCache.load(tmp_path / "missing.json").entries == {}


@pytest.mark.parametrize("content,warns", [
    ("{not json", "unreadable"),
    (json.dumps({"version": 99, "entries": {}}), "schema 99"),
    (json.dumps([1, 2]), "schema ?"),
    (json.dumps({"version": 1, "device": 3, "entries": {}}), "malformed"),
    (json.dumps({"version": 1, "device": CARD, "entries": {
        "gemm:4x256x8:e2m4:nc": {"kind": "gemm", "shape": [4, 256, 8], "fmt": [2, 4],
                                 "config": {"variant": "warp"}},
        "quantize:4x256:e2m4:nc": {"kind": "quantize", "shape": [4, 256], "fmt": [2, 4]},
        "gemm:1x2x3:e2m4:nc": {"kind": "gemm", "shape": [4, 256, 8], "fmt": [2, 4],
                               "config": {"variant": "walk", "bn": 16}}}}),
     "dropping malformed entry"),
], ids=["corrupt", "version", "not-a-dict", "device", "entries"])
def test_broken_cache_files_load_empty_with_a_warning(tmp_path, content, warns):
    p = tmp_path / "c.json"
    p.write_text(content)
    c = at.TuneCache.load(p)
    assert c.entries == {} and any(warns in w for w in c.load_warnings), c.load_warnings


def test_a_cache_of_another_card_or_the_cpu_is_ignored(tmp_path, monkeypatch):
    spec = at.TuneSpec("gemm", (4, 256, 8), F)
    path = _cache((spec, at.BlockConfig("walk", 16)), device="NVIDIA A100").save(
        tmp_path / "c.json")
    monkeypatch.setenv(at.CACHE_ENV_VAR, str(path))
    at.invalidate_cache()
    cache = at.get_cache()
    assert cache.device == "cpu" and cache.entries == {}
    assert any("ignored for resolution" in w for w in cache.load_warnings)
    # on the CPU no cache applies, whatever its card
    own = _cache((spec, at.BlockConfig("walk", 16)), device="cpu")
    got = at.resolve_block_config("gemm", spec.shape, F, k_block=128, cache=own, device="cpu")
    assert got == at.default_block_config(spec) == at.BlockConfig("split", 16)


def test_the_committed_seed_names_its_card_and_is_ignored_on_the_cpu():
    seed = at.TuneCache.load(at.SEED_CACHE_PATH)
    assert not seed.load_warnings and seed.device.startswith("NVIDIA H100"), seed.device
    assert len(seed) >= len(at.specs_named("all"))
    assert at.get_cache().entries == {}


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------
def test_resolution_order_explicit_cache_default(on_card):
    spec = at.TuneSpec("gemm", (256, 512, 256), F)
    default = at.default_block_config(spec)
    assert default == at.BlockConfig("split", 64)  # 16 tiles of 4 groups
    r = lambda **kw: at.resolve_block_config("gemm", spec.shape, F, "nc", k_block=128, **kw)  # noqa: E731
    assert r(cache=at.TuneCache(device=CARD)) == default
    cache = _cache((spec, at.BlockConfig("walk", 32)))
    assert r(cache=cache) == at.BlockConfig("walk", 32)
    assert r(cache=cache, bn=16) == at.BlockConfig("walk", 16)
    assert r(cache=cache, variant="split", bn=None) == at.BlockConfig("split", 32)
    # a winner applies at the group width it was tuned at (JAX's key leaves it out)
    assert at.resolve_block_config("gemm", spec.shape, F, k_block=64, cache=cache) == \
        at.default_block_config(at.TuneSpec("gemm", spec.shape, F, 64))
    with at.override_cache(cache):
        assert r() == at.BlockConfig("walk", 32)
        assert r() is r()  # memoized
    assert r() == at.TuneCache.load(at.SEED_CACHE_PATH).get(spec.key())  # the seed's card
    with pytest.raises(TypeError):
        r(block_m=128)


def test_conv_impl_order_matches_jax_on_the_same_cache(on_card, monkeypatch, tmp_path):
    """env > cfg > cache > implicit-when-legal, as in JAX, on caches that
    pick im2col and implicit at ResNet-20's stage-1 and stage-3 convs."""
    geoms = [(ic.conv_geometry(xs, ws, (s, s), "SAME"), jic.conv_geometry(xs, ws, (s, s), "SAME"))
             for xs, ws, s in (RESNET_CONVS[0], RESNET_CONVS[6], RESNET_CONVS[2])]
    for picks in (("im2col", "implicit"), ("implicit", "im2col")):
        ours, theirs = at.TuneCache(device=CARD), jat.TuneCache(tmp_path / f"{picks[0]}.json")
        for (g, jg), pick in zip(geoms, picks):
            ours.put(at.TuneSpec("conv", ic.conv_tune_dims(g, 144), F, 144),
                     at.BlockConfig(pick, 16 if pick == "implicit" else 0), 1.0)
            theirs.put(jat.TuneSpec("conv", jic.conv_tune_dims(jg, 144), JEMFormat(2, 4), 144),
                       jat.BlockConfig(8, 16, 144, "nc", impl=pick), 1.0)
        theirs.save()
        monkeypatch.setenv(jat.CACHE_ENV_VAR, str(theirs.path))
        jat.invalidate_cache()
        for env in ("", "im2col", "auto"):
            monkeypatch.setenv(ic.CONV_IMPL_ENV_VAR, env)
            for impl in ("auto", "im2col"):
                for g, jg in geoms:
                    want = jic.resolve_conv_impl(jg, JQuantConfig(
                        fmt=JEMFormat(2, 4), k_block=144, conv_impl=impl))
                    with at.override_cache(ours):
                        got = ic.resolve_conv_impl(g, QuantConfig(k_block=144, conv_impl=impl))
                    assert got == want, (g, env, impl, picks)
        jat.invalidate_cache()


def test_a_cached_choice_the_kernel_cannot_run_raises(on_card):
    """No fallback: a cached K4 where the layout is illegal, a cached split
    over the workspace limit, a cached warp over 1024-wide groups."""
    g = ic.conv_geometry(*RESNET_CONVS[2][:2], (2, 2), "SAME")  # 1x1: k_block 144 illegal
    cfg = QuantConfig(k_block=144)
    with at.override_cache(_cache((at.TuneSpec("conv", ic.conv_tune_dims(g, 144), F, 144),
                                   at.BlockConfig("implicit", 32)))):
        with pytest.raises(ValueError, match="cannot run"):
            ic.resolve_conv_impl(g, cfg)
    M, K, N = 2048, 16384, 2048  # 128 groups x 2048 x 2048 x 4 B = 2 GiB of split terms
    with at.override_cache(_cache((at.TuneSpec("gemm", (M, K, N), F), at.BlockConfig("split", 64)))):
        with pytest.raises(ValueError, match="workspace"):
            qd_gemm(torch.zeros((M, K)), torch.zeros((K, N)), None, None, fmt=F,
                    gs_fmt=QuantConfig().gs_fmt, k_block=128, grouping="nc")
    with pytest.raises(ValueError, match="workspace"):
        tuned_plan("split", 64, M, N, K, 128, F)
    x = torch.zeros((2, 2048))
    with at.override_cache(_cache((at.TuneSpec("quantize", (2, 2048), F, 128, "n"),
                                   at.BlockConfig("warp", 0, 1)))):
        with pytest.raises(ValueError, match="warp"):
            qd_gemm(x, torch.zeros((2048, 2)), None, None, fmt=F, gs_fmt=QuantConfig().gs_fmt,
                    k_block=128, grouping="n")


def test_wrappers_record_the_cached_choices_and_keep_the_bits(on_card):
    """A small conv step (im2col at k_block 32) and an implicit forward at
    k_block 36 under a cache of non-default choices: every recorded launch
    carries the cached choice and proves; outputs and gradients equal the
    default's bit for bit."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((2, 16, 8, 8), generator=gen)
    w = torch.randn((16, 16, 3, 3), generator=gen) * 0.1
    g = ic.conv_geometry(x.shape, w.shape, (1, 1), "SAME")
    fwd = at.TuneSpec("gemm", (g.m0, g.k0, g.o), F, 32)
    fwd_x = at.TuneSpec("quantize", (g.m0, 160), F, 32)
    conv = at.TuneSpec("conv", ic.conv_tune_dims(g, 36), F, 36)
    cache = _cache((fwd, at.BlockConfig("split", 16)), (fwd_x, at.BlockConfig("block", 0, 2)),
                   (conv, at.BlockConfig("implicit", 64)))

    def step(kb):
        xx, ww = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = lowbit_conv_fused(xx, ww, 7, (1, 1), "SAME", QuantConfig(k_block=kb))
        y.backward(torch.ones_like(y))
        return y.detach(), xx.grad, ww.grad

    for kb in (32, 36):
        want = step(kb)
        reset_launch_counts()
        with at.override_cache(cache):
            got = step(kb)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        recs = set(launch.RECORDED)
        if kb == 32:
            assert any(k[0] == "mls_matmul" and k[2:5] == (g.m0, g.o, 160)
                       and k[-1].variant == "split" for k in recs), recs
            assert ("mls_quantize_rows", "cpu", g.m0, 160, 32, "block", 2) in recs
        else:
            assert ("implicit_conv", "cpu", g, 36, "nc", F, 64) in recs
        rep = verify_specs("cached", recorded_specs())
        assert rep.ok, rep.first_violation()


# ---------------------------------------------------------------------------
# candidates and their proofs
# ---------------------------------------------------------------------------
def test_every_registry_candidate_proves_on_cpu_descriptors():
    for spec in at.registry_specs():
        cands = at.candidates_for(spec)
        assert cands[0] == at.default_block_config(spec) and len(set(cands)) == len(cands)
        for c in cands:
            rep = at.verify_config(spec, c)
            assert rep.ok, (spec.key(), c, rep.first_violation())


def test_every_registry_candidate_gives_the_plain_bits_on_cpu():
    """The calls the tuner times (``config_call``), here on the kernels'
    plain versions: each candidate's output is the plain call's (the
    registry's specs below 256 x 512, and two small K1 operands)."""
    small = [s for s in at.registry_specs() if max(s.shape[:3]) < 256]
    for spec in small + [at.TuneSpec("quantize", (32, 256), F),
                         at.TuneSpec("quantize", (8, 2048), F, 128, "n")]:
        want = at.config_call(spec, None, device="cpu")()
        for c in at.candidates_for(spec):
            got = at.config_call(spec, c, device="cpu")()
            for a, b in zip(*(t if isinstance(t, tuple) else (t,) for t in (got, want))):
                assert torch.equal(a, b), (spec.key(), c)


def test_illegal_choices_are_not_candidates_and_fail_the_proof():
    wide = at.TuneSpec("quantize", (4, 2048), F, 128, "n")  # one 2048-wide group per row
    assert {c.variant for c in at.quantize_candidates(wide)} == {"block"}
    assert not at.verify_config(wide, at.BlockConfig("warp", 0, 2)).ok
    assert at.quantize_candidates(at.TuneSpec("quantize", (4, 256), F, 128, "c")) == [
        at.BlockConfig("cols")]
    assert not at.verify_config(at.TuneSpec("quantize", (4, 256), F, 128, "nc"),
                                at.BlockConfig("cols")).ok
    big = at.TuneSpec("gemm", (2048, 16384, 2048), F)
    # the split's 2 GiB workspace is illegal; the wgmma variant is legal here
    assert {c.variant for c in at.gemm_candidates(big)} == {"walk", "wgmma"}
    rep = at.verify_config(big, at.BlockConfig("split", 64))
    assert not rep.ok and "workspace" in rep.first_violation()
    g = ic.conv_geometry((1, 16, 8, 4096), (16, 16, 3, 3), (1, 1), "SAME")
    spec = at.TuneSpec("conv", ic.conv_tune_dims(g, 144), F, 144)
    assert ic.implicit_compatible(g, 144)[0] and not ic.band_fits(g, 144)
    assert at.conv_candidates(spec) == [at.BlockConfig("im2col")]
    assert not at.verify_config(spec, at.BlockConfig("implicit", 16)).ok
    small = at.TuneSpec("gemm", (64, 96, 64), F, 32)
    assert {(c.variant, c.bn) for c in at.gemm_candidates(small)} == {
        (v, b) for v in ("walk", "split") for b in (16, 32, 64)}


def test_path_specs_cover_the_main_path():
    specs = at.path_specs()
    keys = {s.key() for s in specs}
    assert len(keys) == len(specs)
    # the stage-1 forward (131072 x 144 x 16) with its padded operands, both groupings
    for g in ("nc", "c"):
        assert f"gemm:131072x144x16:e2m4:{g}" in keys
        assert f"quantize:131072x256:e2m4:{g}" in keys and f"quantize:16x256:e2m4:{g}" in keys
    assert sum(s.kind == "conv" for s in specs) == 5  # the distinct 3x3 convs at k_block 144
    assert "gemm:4x4096x13696:e2m4:nc" in keys and "gemm:8192x4096x13696:e2m4:nc" in keys
    assert "gemm:4x5120x8192:e2m4:nc" in keys  # llama4-scout's shared expert


# ---------------------------------------------------------------------------
# tune, check_cache, the CLI, the audit
# ---------------------------------------------------------------------------
def test_tune_picks_the_fastest_persists_and_short_circuits(tmp_path):
    spec = at.TuneSpec("gemm", (64, 96, 64), F, 32)
    times = {c: 1.0 + i for i, c in enumerate(at.candidates_for(spec))}
    fastest = at.BlockConfig("split", 32)
    times[fastest] = 0.5
    calls = []

    def timer(s, c):
        calls.append(c)
        return times[c]

    cache = at.TuneCache(device=CARD)
    assert at.tune(spec, cache, timer=timer) == fastest
    assert len(calls) == len(times)
    ent = cache.entries[spec.key()]
    assert ent["ms"] == 0.5 and ent["candidates_timed"] == len(times)
    assert at.TuneCache.load(cache.save(tmp_path / "t.json")).get(spec.key()) == fastest
    calls.clear()
    assert at.tune(spec, cache, timer=timer) == fastest and calls == []
    times[fastest] = 9.0
    assert at.tune(spec, cache, timer=timer, force=True) != fastest and calls
    wide = at.TuneSpec("quantize", (4, 2048), F, 128, "n")
    at.tune(wide, cache, timer=lambda s, c: 1.0)
    assert cache.entries[wide.key()]["candidates_pruned"] == 0  # the warp is never listed


def test_check_cache_passes_the_seed_and_names_each_fault():
    seed = at.TuneCache.load(at.SEED_CACHE_PATH)
    rep = at.check_cache(seed)
    assert rep["ok"], rep["failures"]
    assert rep["verified"] == len(seed) and rep["device"] == seed.device
    missing = at.TuneCache(device=CARD)
    rep = at.check_cache(missing)
    assert not rep["ok"] and all("has no tuning-cache entry" in f for f in rep["failures"])
    spec = at.TuneSpec("quantize", (4, 2048), F, 128, "n")
    planted = _cache((spec, at.BlockConfig("warp", 0, 2)))
    rep = at.check_cache(planted, specs=[spec])
    assert not rep["ok"] and "does not verify" in rep["failures"][0]
    offgrid = _cache((at.TuneSpec("quantize", (4096, 256), F), at.BlockConfig("block", 0, 100)))
    rep = at.check_cache(offgrid, specs=[])
    assert rep["failures"] == [
        "cache entry quantize:4096x256:e2m4:nc: winner BlockConfig(variant='block', bn=0, "
        "amax_blocks=100) is not a candidate of its spec"]


def _planted(tmp_path) -> Path:
    seed = at.TuneCache.load(at.SEED_CACHE_PATH)
    spec = at.registry_specs()[0]  # quantize 256 x 512
    seed.put(spec, at.BlockConfig("cols"), 1.0)
    return seed.save(tmp_path / "planted.json")


def test_cli_exit_codes(tmp_path, capsys):
    assert at.main(["--check"]) == 0
    assert "tuning cache: OK" in capsys.readouterr().out
    assert at.main(["--check", "--cache", str(_planted(tmp_path))]) == 1
    assert "does not verify" in capsys.readouterr().err
    assert at.main(["--check", "--specs", "registry", "--cache", str(tmp_path / "no.json")]) == 1
    assert at.main(["--tune"]) == 2  # no card here
    with pytest.raises(SystemExit) as e:
        at.main([])
    assert e.value.code == 2


def test_the_module_cli_runs_the_package_copy(tmp_path):
    """``python -m repro_torch.kernels.autotune`` runs ``main`` of the
    package's module (the one the wrappers resolve through), not of the
    ``__main__`` copy: a conv candidate's timing sets that module's cache."""
    code = ("import runpy, sys; "
            "import repro_torch.kernels.autotune as at; calls = []; "
            "at.main = lambda: calls.append(1) or 0\n"
            "try:\n runpy.run_module('repro_torch.kernels.autotune', run_name='__main__')\n"
            "except SystemExit as e:\n assert e.code == 0 and calls == [1], (e.code, calls)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                                            "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_audit_gate_fails_on_a_stale_cache(tmp_path):
    args = ["--device", "cpu", "--graph", "none", "--kernels", "--gate"]
    assert audit.main([*args, "--out", str(tmp_path / "ok.json")]) == 0
    report = json.loads((tmp_path / "ok.json").read_text())
    assert report["tune_cache"]["ok"] and report["tune_cache"]["device"].startswith("NVIDIA")
    assert audit.main([*args, "--tune-cache", str(_planted(tmp_path)),
                       "--out", str(tmp_path / "stale.json")]) == 1
    report = json.loads((tmp_path / "stale.json").read_text())
    assert any(f.startswith("tune cache: ") for f in report["gate"]["failures"])


# ---------------------------------------------------------------------------
# bytes models, the bench
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("xs,ws,s,kb", [((128, 16, 32, 32), (16, 16, 3, 3), 1, 144),
                                        ((128, 16, 32, 32), (32, 16, 3, 3), 2, 144),
                                        ((128, 64, 8, 8), (64, 64, 3, 3), 1, 144),
                                        ((4, 32, 9, 7), (50, 32, 3, 3), 1, 96)])
def test_bytes_models_sum_their_terms(xs, ws, s, kb):
    g = ic.conv_geometry(xs, ws, (s, s), "SAME")
    for grouping in ("nc", "c", "n", "none"):
        for model in (ic.im2col_conv_bytes(g, kb),
                      ic.implicit_conv_bytes(g, kb, grouping=grouping)):
            assert model["total"] == sum(v for k, v in model.items() if k != "total") > 0
    if xs == (128, 16, 32, 32) and s == 1:  # ResNet-20's stage-1 conv
        assert ic.im2col_conv_bytes(g, kb)["total"] >= 3 * ic.implicit_conv_bytes(g, kb)["total"]


def test_kernel_bench_small_on_cpu_writes_its_payload(tmp_path):
    out = tmp_path / "bench.json"
    proc = subprocess.run([sys.executable, str(ROOT / "benchmarks" / "torch_kernel_bench.py"),
                           "--device", "cpu", "--small", "--json", str(out)],
                          capture_output=True, text=True, timeout=300, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    payload = json.loads(out.read_text())
    assert payload["suite"] == "torch_kernel_bench" and payload["backend"] == "cpu"
    names = {r["kernel"] for r in payload["rows"]}
    assert names == {"mls_quantize_rows", "mls_quantize_given_sg", "mls_matmul", "implicit_conv",
                     "sabotage_overlap"}
    for r in payload["rows"]:
        assert r["schema_version"] == 1 and r["bound_ms"] > 0 and r["bound_by"] in (
            "bytes", "operations")
        assert r["default"]["config"] and r["tuned"]["config"]
        assert r["default"]["ms"] is r["tuned"]["device_ms"] is r["kernel_ms"] is None  # CPU
