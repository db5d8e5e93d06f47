"""The port's analysis (``repro_torch.analysis``) against the JAX package's.

- K4's window proof against ``repro.analysis.kernel_verify.prove_window_grid``
  on ResNet-20's convs and on the JAX ``drop_halo`` geometry: the same
  verdict and the same violation kinds.
- The verifier's accumulator width against
  ``repro.core.formats.accumulation_bits``.
- The lint against ``repro.analysis.lint`` on every rule but the tiling
  rule, which differs by design and is asserted on its own.
- The coverage fraction of a small ResNet-20 step against its closed form,
  every registry entry clean, every sabotage mode failing the gate, and
  baselines no looser than the JAX package's.
- The serve graph (one quantized decode step of qwen2-72b's smoke config)
  against its closed form, passing the gate with every recorded launch
  proven; the fake-quant backend there fails it.

Everything runs on the CPU (the kernels' plain versions) at small sizes.
"""
import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.analysis import kernel_verify as jkv  # noqa: E402
from repro.analysis import lint as jlint  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core.formats import EMFormat as JEMFormat  # noqa: E402
from repro.core.formats import accumulation_bits  # noqa: E402
from repro.kernels import implicit_conv as jic  # noqa: E402
from repro_torch.analysis import audit, kernel_verify as kv, lint  # noqa: E402
from repro_torch.analysis.graphs import cifar_train_graph, serve_decode_graph  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core import EMFormat, QuantConfig  # noqa: E402
from repro_torch.kernels import implicit_conv as ic  # noqa: E402
from repro_torch.kernels.mls_matmul import TILE as MM_TILE  # noqa: E402
from repro_torch.kernels.mls_matmul import launch_spec as matmul_spec  # noqa: E402
from repro_torch.kernels import recorded_specs  # noqa: E402
from repro_torch.kernels.registry import KERNEL_REGISTRY  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# full-width ResNet-20's conv geometries: (x, w, stride)
RESNET_CONVS = [
    ((128, 16, 32, 32), (16, 16, 3, 3), 1),
    ((128, 16, 32, 32), (32, 16, 3, 3), 2),
    ((128, 16, 32, 32), (32, 16, 1, 1), 2),
    ((128, 32, 16, 16), (32, 32, 3, 3), 1),
    ((128, 32, 16, 16), (64, 32, 3, 3), 2),
    ((128, 32, 16, 16), (64, 32, 1, 1), 2),
    ((128, 64, 8, 8), (64, 64, 3, 3), 1),
]


# ---------------------------------------------------------------------------
# K4's window proof
# ---------------------------------------------------------------------------
def _window_kinds(xs, ws, s, cb, short=False):
    """Violation kinds of both window proofs for one conv, ``cb`` channels
    per k-block; ``short`` drops one row of the halo band (both)."""
    jgeom = jic.conv_geometry(xs, ws, (s, s), "SAME")
    geom = ic.conv_geometry(xs, ws, (s, s), "SAME")
    bh = 2  # JAX's M-tile height in output rows; divides every OH here
    band = jgeom.sh * (bh - 1) + jgeom.kh
    jviols, _ = jkv.prove_window_grid(jgeom, bh, cb, 64,
                                      band_h_override=band - 1 if short else None)
    tallest = int(ic.band_rows(geom)[1].max())
    viols, _ = kv.prove_window_grid(geom, cb * geom.kk,
                                    band_rows=tallest - 1 if short else None)
    return {v.kind for v in jviols}, {v.kind for v in viols}


@pytest.mark.parametrize("conv", RESNET_CONVS,
                         ids=lambda c: f"{c[0][1]}to{c[1][0]}k{c[1][2]}s{c[2]}")
def test_window_proof_agrees_with_jax_on_resnet20(conv):
    xs, ws, s = conv
    jkinds, kinds = _window_kinds(xs, ws, s, cb=16)
    assert jkinds == kinds == set()


@pytest.mark.parametrize("case", ["drop_halo", "cb_not_dividing_c"])
def test_window_proof_agrees_with_jax_on_broken_grids(case):
    """The JAX drop_halo geometry (x (2, 4, 8, 8), w (8, 4, 3, 3), SAME, two
    channels per k-block) one row short: oob in both.  Three channels per
    k-block of four: divisibility in both."""
    if case == "drop_halo":
        jkinds, kinds = _window_kinds((2, 4, 8, 8), (8, 4, 3, 3), 1, cb=2, short=True)
        assert jkinds == kinds == {"oob"}
    else:
        jkinds, kinds = _window_kinds((2, 4, 8, 8), (8, 4, 3, 3), 1, cb=3)
        assert jkinds == kinds == {"divisibility"}


def test_drop_halo_control_names_the_short_input():
    rep = kv._sabotage_drop_halo("cpu")
    assert not rep.ok and {v.kind for v in rep.violations} == {"oob"}
    assert all("short of its taps" in v.detail for v in rep.violations)


# (x, w, stride, padding, k_block): SAME/VALID, stride 1/2, ragged M0
# (tiles spanning two images, a short last tile), several k-blocks
BAND_GEOMS = [
    ((3, 5, 9, 9), (7, 5, 3, 3), 1, "SAME", 9),
    ((2, 8, 12, 12), (6, 8, 3, 3), 2, "VALID", 36),
    ((2, 4, 10, 10), (6, 4, 3, 3), 2, "SAME", 18),
    ((1, 3, 11, 7), (4, 3, 1, 1), 2, "SAME", 3),
    ((2, 6, 7, 7), (5, 6, 5, 5), 1, "VALID", 50),
]


@pytest.mark.parametrize("conv", BAND_GEOMS, ids=str)
@pytest.mark.parametrize("short", [False, True], ids=["band", "short_band"])
def test_window_proof_holds_the_staged_band(conv, short):
    """Every tap of every row lies in its tile's staged band, which fits the
    kernel's shared memory; a band one row short names the oob."""
    xs, ws, s, pad, kb = conv
    geom = ic.conv_geometry(xs, ws, (s, s), pad)
    tallest = int(ic.band_rows(geom)[1].max())
    viols, cov = kv.prove_window_grid(geom, kb, band_rows=tallest - 1 if short else None)
    if short:
        assert {v.kind for v in viols} == {"oob"}
        assert all("short of its taps" in v.detail for v in viols)
    else:
        assert viols == []
        assert cov["band_rows"] == tallest and cov["rows_produced"] == geom.m0
        assert cov["band_bytes"] == kb // geom.kk * tallest * geom.wp * 4


@pytest.mark.parametrize("conv", RESNET_CONVS[:2] + RESNET_CONVS[-1:],
                         ids=["stage1", "stage2_s2", "stage3"])
@pytest.mark.parametrize("grouping", ["nc", "none", "c", "n"])
def test_k4_launch_specs_prove_at_the_three_stages(conv, grouping):
    """K4's launches at full-width ResNet-20's stage convs, k_block 144:
    the scale passes of each grouping (pass A for "nc" and "none"; the
    patch maxima for "n"; plane maxima, group maxima and scales for "c")
    and the main launch, every program proven and the band within the
    sizes the design names (8.7 / 19 / 6.4 KB)."""
    xs, ws, s = conv
    geom = ic.conv_geometry(xs, ws, (s, s), "SAME")
    specs = ic.launch_spec(geom, 144, grouping, EMFormat(2, 4))
    first = {"nc": ["conv_amax"], "none": ["conv_amax"], "n": ["conv_win_amax"],
             "c": ["conv_chan_amax", "conv_group_reduce", "conv_chan_scales"]}[grouping]
    assert [sp.kernel for sp in specs] == first + ["implicit_conv"]
    rep = kv.verify_specs("k4", [(sp, 1) for sp in specs])
    assert rep.ok, rep.violations
    assert all(c.exhaustive for c in rep.calls)
    band = rep.calls[-1].coverage["window_grid"]["band_bytes"]
    assert band == {16: 8704, 32: 19008, 64: 6400}[ws[0]]
    # each scale pass writes each block of its outputs once
    for call in rep.calls[:-1]:
        for out in call.coverage.values():
            assert out["max_writers"] == 1 and out["blocks_written"] == out["output_blocks"]
    if grouping == "n":  # one patch max per output row
        assert rep.calls[0].coverage["outputs[1]"]["output_blocks"] == geom.m0
    scale = ic.launch_spec_scale(geom)
    assert kv.verify_specs("k4_scale", [(sp, 1) for sp in scale]).ok


# ---------------------------------------------------------------------------
# accumulator width
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k_block", [16, 32, 128, 144, 1024, 2048])
@pytest.mark.parametrize("fmt", [(2, 4), (2, 1), (0, 4)], ids=lambda f: f"e{f[0]}m{f[1]}")
def test_accumulation_bits_agree_with_the_closed_form(fmt, k_block):
    bits = kv.prove_matmul_accumulation_bits(EMFormat(*fmt), k_block)
    assert bits == accumulation_bits(JEMFormat(*fmt), k_block)
    flagged = any("no longer" in e for e in lint.check_format_pair(EMFormat(*fmt), k_block))
    assert (bits >= 24) == flagged


def test_accumulation_bits_at_the_issue_points():
    fmt = EMFormat(2, 4)
    assert [kv.prove_matmul_accumulation_bits(fmt, kb) for kb in (128, 144, 1024, 2048)] == \
        [21, 22, 24, 25]


# ---------------------------------------------------------------------------
# lint
# ---------------------------------------------------------------------------
# (fmt, gs_fmt, k_block, grouping): k_block a multiple of 32 keeps the
# port's tiling rule quiet; the JAX backend "fake_quant" keeps its own quiet
LINT_CASES = [
    ((2, 4), (8, 1), 128, "nc"),
    ((2, 4), (8, 1), 512, "c"),  # one bit of headroom: a warning
    ((2, 1), (3, 1), 64, "n"),  # narrow group-scale exponent: a warning
    ((2, 4), (8, 3), 32, "none"),  # Mg > 2: an error
    ((0, 4), (2, 3), 1024, "nc"),  # both
]


@pytest.mark.parametrize("case", LINT_CASES, ids=str)
def test_lint_agrees_with_jax(case):
    fmt, gs, kb, grouping = case
    got = lint.lint_quant_config(QuantConfig(fmt=EMFormat(*fmt), gs_fmt=EMFormat(*gs),
                                             k_block=kb, grouping=grouping))
    want = jlint.lint_quant_config(JQuantConfig(fmt=JEMFormat(*fmt), gs_fmt=JEMFormat(*gs),
                                                k_block=kb, grouping=grouping))
    assert (got.errors, got.warnings) == (want.errors, want.warnings)


@pytest.mark.parametrize("pair", [((2, 4), 2048), ((2, 4), 512), ((4, 4), 16), ((2, 5), 256)])
def test_format_pair_check_agrees_with_jax(pair):
    (e, m), kb = pair
    assert lint.check_format_pair(EMFormat(e, m), kb) == \
        jlint.check_format_pair(JEMFormat(e, m), kb)


def test_tiling_rule_is_the_ports_own():
    """JAX's Pallas backend needs a power-of-two k_block and errors on 144;
    the port takes 144 without a warning (K3's 16-wide k step divides it)
    and warns on a k_block off that step, whose last step of each group is
    part empty."""
    jres = jlint.lint_quant_config(JQuantConfig(k_block=144, backend="pallas"))
    assert any("power-of-two" in e for e in jres.errors)
    res = lint.lint_quant_config(QuantConfig(k_block=144))
    assert res.ok and res.warnings == []
    res = lint.lint_quant_config(QuantConfig(k_block=36))
    assert res.ok and res.warnings == [
        "k_block=36 is not a multiple of K3's 16-wide k step: each scaling group runs 3 "
        "steps with 12 of 48 slots empty, and its codes are staged without cp.async"]
    assert lint.lint_quant_config(QuantConfig(k_block=128)).warnings == []
    presets = lint.lint_shipped_presets()
    assert set(presets) == {"train:mls<2,4>", "train:mls<2,1>"}
    assert all(r.ok for r in presets.values())


# ---------------------------------------------------------------------------
# coverage
# ---------------------------------------------------------------------------
def _closed_form(k_block, width, hw, batch):
    """(quantized, full-precision) MACs of one ResNet-20 step: three GEMMs
    per quantized conv as launched (K padded to k_block; the forward on K4
    where the dispatch takes it) against the fp32 stem (forward and weight
    gradient) and classifier (forward and both gradients)."""
    qcfg = QuantConfig(k_block=k_block)
    c = [max(4, round(v * width)) for v in (16, 32, 64)]
    convs, c_in, h = [], c[0], hw
    for stage, c_out in enumerate(c):
        for b in range(3):
            s = 2 if (b == 0 and stage > 0) else 1
            convs.append(((batch, c_in, h, h), (c_out, c_in, 3, 3), s))
            if s != 1 or c_in != c_out:
                convs.append(((batch, c_in, h, h), (c_out, c_in, 1, 1), s))
            h = -(-h // s)
            convs.append(((batch, c_out, h, h), (c_out, c_out, 3, 3), 1))
            c_in = c_out
    pad = lambda k: -(-k // k_block) * k_block  # noqa: E731
    q = 0
    for xs, ws, s in convs:
        g = ic.conv_geometry(xs, ws, (s, s), "SAME")
        fwd = g.m0 * g.k0 * g.o if ic.resolve_conv_impl(g, qcfg) == "implicit" \
            else g.m0 * g.o * pad(g.k0)
        q += fwd + g.k0 * g.o * pad(g.m0) + g.m0 * g.k0 * pad(g.o)
    fp = 2 * batch * c[0] * hw * hw * 3 * 9 + 3 * batch * c[2] * 10
    return q, fp


@pytest.mark.parametrize("k_block", audit.TRAIN_K_BLOCKS)
def test_coverage_of_a_small_step_equals_the_closed_form(k_block):
    width, hw, batch = 0.25, 16, 2
    cov, records = cifar_train_graph(k_block, width, hw, batch, "cpu").run()
    q, fp = _closed_form(k_block, width, hw, batch)
    assert (cov.quantized_macs, cov.full_precision_macs) == (q, fp)
    assert cov.quantized_fraction >= 0.99
    assert cov.data_movement_macs > 0  # F.unfold of the im2col GEMMs
    sab, _ = cifar_train_graph(k_block, width, hw, batch, "cpu", sabotage=True).run()
    assert sab.full_precision_macs == fp + batch * (3 * hw * hw) ** 2
    assert sab.quantized_fraction < 0.99
    assert sum(records.values()) > 0


# ---------------------------------------------------------------------------
# registry, sabotage, baselines
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(KERNEL_REGISTRY))
def test_registry_entry_verifies_clean(name):
    rep = kv.verify_entry(KERNEL_REGISTRY[name], "cpu")
    assert rep.ok, rep.violations
    assert rep.calls and all(c.exhaustive for c in rep.calls)
    assert rep.max_integer_bits <= 23


def test_registry_covers_every_kernel_of_the_training_path():
    kernels = set()
    for entry in KERNEL_REGISTRY.values():
        kernels |= {s.kernel for s, _ in recorded_specs(entry.run("cpu"))}
    assert kernels == {"quantize_amax", "quantize_groups_warp", "quantize_cols_amax",
                       "quantize_cols_reduce", "quantize_scales", "quantize_codes",
                       "mls_matmul_walk", "mls_matmul_terms", "mls_matmul_sum",
                       "mls_matmul_decode", "mls_matmul_wgmma",
                       "conv_amax", "implicit_conv", "conv_win_amax", "conv_chan_amax",
                       "conv_group_reduce", "conv_chan_scales", "conv_scale"}
    baseline = json.loads((ROOT / "src" / "repro_torch" / "analysis" / "baselines"
                           / "kernels.json").read_text())
    assert set(baseline["require_device_kernels"]) == kernels


SMALL = ["--device", "cpu", "--width", "0.25", "--hw", "16", "--batch", "2"]


def test_clean_audit_passes_the_gate(tmp_path):
    out = tmp_path / "a.json"
    assert audit.main([*SMALL, "--graph", "train", "--kernels", "--gate", "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["gate"]["pass"] and report["kernels"]["ok"]
    assert set(report["graphs"]) == {"train:resnet20", "train:resnet20@kb144"}
    recorded = report["kernels"]["kernels"]["train:resnet20@kb144"]["calls"]
    assert any(c["kernel"].split(" ")[1].startswith("implicit_conv") for c in recorded)


@pytest.mark.parametrize("mode,graph,named", [
    ("overlap_write", "none", ["overlap violation at outputs[0]", "gap violation at outputs[0]"]),
    ("deep_k", "none", ["overflow violation", "spans 25 bits > baseline 23"]),
    ("drop_halo", "none", ["oob violation at window_grid"]),
    ("fp32_gemm", "train", ["train:resnet20: quantized fraction", "aten.mm"]),
])
def test_every_sabotage_mode_fails_the_gate(tmp_path, mode, graph, named):
    out = tmp_path / "a.json"
    args = [*SMALL, "--graph", graph, "--gate", "--sabotage", mode, "--out", str(out)]
    if graph == "none":
        args.append("--kernels")
    assert audit.main(args) == 1
    failures = "\n".join(json.loads(out.read_text())["gate"]["failures"])
    for text in named:
        assert text in failures, failures


def test_baselines_are_no_looser_than_the_jax_ones():
    jdir = ROOT / "src" / "repro" / "analysis" / "baselines"
    pdir = ROOT / "src" / "repro_torch" / "analysis" / "baselines"
    jgate, pgate = (json.loads((d / "gate.json").read_text()) for d in (jdir, pdir))
    jk, pk = (json.loads((d / "kernels.json").read_text()) for d in (jdir, pdir))
    key = "train:resnet20"
    assert pgate["min_quantized_fraction"][key] >= jgate["min_quantized_fraction"][key] == 0.99
    assert pk["max_integer_accumulation_bits"] <= jk["max_integer_accumulation_bits"] == 23
    assert [n.removesuffix("_pallas") for n in jk["require_kernels"]] == pk["require_kernels"]
    assert set(pk["require_kernels"]) == set(KERNEL_REGISTRY)


def test_launch_spec_macs_and_accumulation_follow_the_launch():
    geom = ic.conv_geometry((2, 16, 8, 8), (32, 16, 3, 3), (2, 2), "SAME")
    amax, spec = ic.launch_spec(geom, 144, "nc", EMFormat(2, 4))
    assert amax.macs == 0
    assert spec.macs == geom.m0 * geom.k0 * geom.o == 32 * 144 * 32
    assert spec.shape == (math.ceil(32 / 64), 1, 1)
    (acc,) = spec.accumulations
    assert (acc.depth, acc.operand_bound, acc.bits) == (144, 124, 22)


def test_audit_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        audit.main(["--graph", "none", "--kernels", "--out", str(tmp_path / "a.json")])


def test_candidate_oracles_prove_and_reject():
    """The legality oracles an autotuner would ask: a legal GEMM, quantizer
    and implicit conv verify clean; a 25-bit group, a ragged K and an
    illegal conv k_block are refused with the violation that names them."""
    fmt = EMFormat(2, 4)
    assert kv.verify_candidate((144, 131072, 16), QuantConfig(k_block=128)).ok
    assert kv.verify_candidate((100, 300, 70), (fmt, 32), grouping="c").ok
    deep = kv.verify_candidate((8, 2048, 8), (fmt, 2048))
    assert {v.kind for v in deep.violations} == {"overflow"}
    assert kv.verify_quantize_candidate((144, 131072), fmt, 131072, grouping="n").ok
    ragged = kv.verify_quantize_candidate((64, 200), fmt, 128)
    assert {v.kind for v in ragged.violations} == {"divisibility"}
    geom = ic.conv_geometry((2, 16, 8, 8), (16, 16, 3, 3), (1, 1), "SAME")
    rep = kv.verify_implicit_conv_candidate(geom, fmt, 36)
    assert rep.ok and {c.kernel.split(" ")[1].split("[")[0] for c in rep.calls} == {
        "quantize_amax", "quantize_groups_warp", "conv_amax", "implicit_conv"}
    bad = kv.verify_implicit_conv_candidate(geom, fmt, 32)
    assert {v.kind for v in bad.violations} == {"divisibility"}


@pytest.mark.parametrize("k_block", audit.TRAIN_K_BLOCKS)
def test_stage1_weight_gradient_runs_a_parallel_proven_grid(k_block):
    """Full-width ResNet-20's stage-1 weight gradient (144 x N*OH*OW x 16,
    K padded to k_block): K3's term phase is a fully parallel grid of at
    least 132 programs writing each workspace block once, and the ordered
    sum walks the groups in order; both proven, the dot within 23 bits."""
    K = -(-131072 // k_block) * k_block
    terms, ordered = matmul_spec(144, 16, K, k_block, "nc", EMFormat(2, 4))
    assert (terms.kernel, terms.sequential) == ("mls_matmul_terms", 0)
    assert math.prod(terms.shape) == 3 * (K // k_block) >= 132
    assert (ordered.kernel, ordered.sequential) == ("mls_matmul_sum", 1)
    assert ordered.shape == (-(-144 * 16 // MM_TILE["kSumThreads"]), K // k_block)
    assert (terms.macs, ordered.macs) == (144 * 16 * K, 0)
    rep = kv.verify_specs("stage1_wgrad", [(terms, 1), (ordered, 1)])
    assert rep.ok, rep.violations
    assert all(c.exhaustive for c in rep.calls)
    assert rep.max_integer_bits <= 23
    ws = rep.calls[0].coverage["outputs[1]"]
    assert ws["blocks_written"] == ws["output_blocks"] == 3 * (K // k_block)
    assert ws["max_writers"] == ws["revisit_depth"] == 1
    out = rep.calls[1].coverage["outputs[0]"]
    assert out["max_writers"] == 1 and out["revisit_depth"] == K // k_block


def test_serve_graph_passes_the_gate_with_its_closed_form(tmp_path):
    """One decode step (batch 4, cache 128) of qwen2-72b's smoke config:
    each of the 7 quantized linears per layer launches K1 twice and K3 once,
    its K (64 or 96) padded to one 128-wide group; the fp32 MACs are the LM
    head and the two attention contractions over the 128 cache slots.

    The port's gate is 0.61, not the JAX package's 0.95: the JAX audit counts
    a Pallas GEMM's MACs over its zero-padded 128 x 128 output tiles (M = 4
    rows padded to 128), which puts the same step at 0.991; the port counts
    the M x N x K a launch computes."""
    out = tmp_path / "a.json"
    assert audit.main(["--device", "cpu", "--graph", "serve", "--kernels", "--gate",
                       "--out", str(out)]) == 0
    report = json.loads(out.read_text())
    assert report["gate"]["baseline"]["min_quantized_fraction"]["serve:qwen2-72b"] == 0.61
    entry = report["graphs"]["serve:qwen2-72b"]
    cfg, b, m, kb = get_smoke_config("qwen2-72b"), 4, 128, 128
    d, hd = cfg.d_model, cfg.hd
    n_out = [cfg.n_heads * hd, cfg.n_kv_heads * hd, cfg.n_kv_heads * hd, d, cfg.d_ff, cfg.d_ff, d]
    q = cfg.n_layers * b * kb * sum(n_out)
    fp = b * d * cfg.vocab + cfg.n_layers * 2 * b * cfg.n_heads * m * hd
    cov = entry["coverage"]
    assert (cov["quantized_macs"], cov["full_precision_macs"]) == (q, fp)
    assert entry["launches"] == cfg.n_layers * 7 * 3 and entry["lint"]["ok"]
    assert cov["quantized_fraction"] == round(q / (q + fp), 6) >= 0.61
    padded = cfg.n_layers * 7 * 128 ** 3  # the JAX audit's count of the same GEMMs
    assert padded / (padded + fp) >= 0.95 > cov["quantized_fraction"]
    kernels = report["kernels"]["kernels"]["serve:qwen2-72b"]
    assert kernels["ok"] and kernels["calls"]
    assert {c["kernel"].split(" ")[1].split("[")[0] for c in kernels["calls"]} >= {
        "quantize_amax", "quantize_groups_warp", "mls_matmul_walk"}
    assert all(not c["violations"] for c in kernels["calls"])

    fake = serve_decode_graph("cpu", backend="fake_quant")
    fcov, records = fake.run()
    assert fcov.quantized_macs == 0 and not records
    report = {"graphs": {fake.name: {"coverage": fcov.to_json(), "lint": {"ok": True}}}}
    failures = audit.apply_gate(report, json.loads(
        (ROOT / "src" / "repro_torch" / "analysis" / "baselines" / "gate.json").read_text()))
    assert failures and "serve:qwen2-72b: quantized fraction" in failures[0]
