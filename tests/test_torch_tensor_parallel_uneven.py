"""Tensor parallelism where the ``model`` axis does not divide
(``repro_torch.parallel.tensor``): query heads split unevenly in whole
units with an irregular kv map, an attention kept replicated where it has
fewer units than ranks, a vocabulary kept replicated where the axis does
not divide it, on a world of 4 gloo processes on the CPU (model 4),
against the unsharded port and the JAX package's unsharded ``lm_loss``.

The cases (``torch_dist_workers.UNEVEN_CASES``) are smoke configs widened
as the launcher widens them (``launch.train.tp_smoke``), fp32, unquantized,
on the fake-quant backend and on the quantized one (K1/K3's plain
versions), stochastic rounding from one key:

- ``uneven``: chatglm3-6b's with 10 query heads of 128 over 2 kv heads:
  3 / 3 / 2 / 2 heads, the kv heads replicated, rank 1's heads 3, 4, 5
  reading kv heads 0, 0, 1 (``parallel.tensor.kv_map``);
- ``attn_dense``, ``attn_encdec``, ``attn_hybrid``: chatglm3-6b's,
  seamless-m4t-medium's and zamba2-7b's with 2 heads of 32 (one scaling
  group of 128 between them, and fewer heads than ranks unquantized): the
  attention (the encoder's, the decoder's self- and cross-attention, the
  hybrid's shared block's) whole on every rank, its MLP split;
- ``vocab_untied``, ``vocab_tied``: chatglm3-6b's and mamba2-370m's with a
  vocabulary of 101: ``emb`` (and ``lm_head``) whole on every rank.

Checks:

- Each case and backend, the whole step against the unsharded port: the
  loss within 1e-6 relative and each gradient slice within 1e-5 relative
  in the L2 norm; the quantized steps feed each linear the unsharded
  step's input and output gradient (``torch_dist_workers._linear_feed``),
  since a row-parallel sum's order can move a stochastic-rounding code.
  The quantized step's launches per rank equal
  ``chip_smoke.lm_train_launches(cfg, model_axis=4)``.
- The replicated attentions of layer 0 (and of the encoder's layer 0, and
  the hybrid's shared block) on one seeded input and output gradient: the
  output, the input's (and cross-attention source's) gradient and the
  weight gradients the unsharded layer's bit for bit, on every backend.
- The unquantized step on the JAX package's parameters against JAX's
  unsharded ``lm_loss`` and ``jax.grad``: within 1e-4.
- Serving each case and backend (a prefill of 2 prompts of 8 tokens, 4
  decode steps teacher-forced): every step's logits within 1e-5 relative
  of the unsharded port's (quantized: fed), equal on every rank; layer
  0's cache after the prefill the rank's slice of the unsharded one (the
  kv heads its query heads read; all of them for a replicated attention;
  unquantized, the K/V computed after row-parallel sums, the hybrid's and
  the cross-attention's, within 1e-6 relative), in the shapes
  ``lm.cache_spec(..., tp=...)`` gives; the quantized decode step's
  launches ``chip_smoke.serve_launches(cfg, model_axis=4)``; the greedy
  tokens the unsharded engine's.
- ``tp_layout`` of the full configs at model 16: yi-34b's ``wq`` in 8
  ranks of 4 heads and 8 of 3, llama4-scout's in 3 / 2; seamless's and
  zamba2-7b's shared attention absent (replicated); mamba2-370m's ``emb``
  absent.  K1's split entries and K3 proved at yi-34b's rank shapes at
  model 16 (``kernel_verify.TP_AUDIT_UNEVEN``: rank 0's 512 columns of
  ``wq`` and rows of ``wo``, rank 15's 384).
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import torch_dist_workers as workers  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis.lint import lint_tensor_parallel  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.parallel.tensor import (  # noqa: E402
    attention_heads, kv_map, rank_heads, tp_layout)

CASES = tuple(workers.UNEVEN_CASES)
ATTN_CASES = tuple(c for c in CASES if c.startswith("attn_"))
M = workers.UNEVEN_AXIS
# the fields a case's config may differ in from the JAX package's smoke config
FIELDS = ("n_heads", "n_kv_heads", "head_dim", "d_ff", "vocab", "d_model", "ssm_headdim",
          "moe_d_ff")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """Per case: JAX's unquantized loss and gradients on the workers' batch
    (the encoder-decoder's ``src_emb`` too) and its parameters, each as the
    port's state dict."""
    out = {}
    for case, (arch, _) in workers.UNEVEN_CASES.items():
        cfg = workers.uneven_config(case, "off")
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch),
                                   **{k: getattr(cfg, k) for k in FIELDS}, quant=False)
        params = jlm.init_lm(jax.random.key(0), jcfg)
        batch = {k: jnp.asarray(v.numpy()) for k, v in workers.tp_batch(cfg, 2).items()}
        fn = jax.jit(jax.value_and_grad(lambda p, b, c=jcfg: jlm.lm_loss(p, b, c, None),
                                        has_aux=True))
        (loss, _), grads = fn(params, batch)
        out[case] = dict(state=lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
                         loss=float(loss),
                         grads=lm_params_from_jax(jax.tree.map(np.asarray, grads), cfg))
    return out


@pytest.fixture(scope="module")
def tp4(jax_ref):
    return workers.run_world(workers.uneven_tp4_worker, M,
                             {c: r["state"] for c, r in jax_ref.items()})


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


STEPS = [(case, backend) for case in CASES for backend in workers.TP_BACKENDS]


def test_uneven_heads_split_in_whole_units_with_an_irregular_kv_map(tp4):
    cfg = workers.uneven_config("uneven", "pallas")
    assert attention_heads(cfg, M) == ((0, 3), (3, 6), (6, 8), (8, 10))
    want = [((3, 1, (0, 1)), None), ((3, 2, (0, 2)), (0, 0, 1)), ((2, 1, (1, 2)), None),
            ((2, 1, (1, 2)), None)]
    assert [r["heads"] for r in tp4] == want
    layout = tp4[0]["steps"][("uneven", "pallas")]["layout"]
    assert layout["layers.0.attn.wq.w"].bounds == ((0, 384), (384, 768), (768, 1024),
                                                  (1024, 1280))
    assert layout["layers.0.attn.wo.w"].dim == 0
    assert "layers.0.attn.wk.w" not in layout and "layers.0.attn.wv.w" not in layout
    res = lint_tensor_parallel(cfg, M)
    assert res.ok and "query heads split unevenly in whole units: 3 / 2" in res.warnings


@pytest.mark.parametrize("case,backend", STEPS, ids=lambda v: str(v))
def test_tp_step_matches_the_unsharded_port_at_model_4(tp4, case, backend):
    for rank, r in enumerate(tp4):
        s = r["steps"][(case, backend)]
        assert abs(s["loss"].item() - s["ref_loss"].item()) <= 1e-6 * abs(s["ref_loss"].item())
        for k, g in s["grads"].items():
            ref = s["ref_grads"][k]
            if k in s["layout"]:
                ref = s["layout"][k].take(ref, rank)
            assert g.shape == ref.shape and _rel(g, ref) <= 1e-5, k
        layout = s["layout"]
        if case.startswith("vocab_"):
            assert "emb" not in layout and "lm_head" not in layout
        else:
            assert "emb" in layout
        if case.startswith("attn_"):
            assert not any(".attn.w" in k or ".xattn.w" in k for k in layout), sorted(layout)
            assert any("mlp.w_up" in k for k in layout)  # the MLP still splits


@pytest.mark.parametrize("case,backend", [(c, b) for c in ATTN_CASES
                                          for b in workers.TP_BACKENDS], ids=lambda v: str(v))
def test_replicated_attention_is_the_unsharded_layer_bit_for_bit(tp4, case, backend):
    want_names = {"attn_dense": {"layers.0.attn"},
                  "attn_encdec": {"enc_layers.0.attn", "layers.0.attn", "layers.0.xattn"},
                  "attn_hybrid": {"shared_attn.attn"}}[case]
    for r in tp4:
        run = r["attention"][(case, backend)]
        assert set(run["got"]) == want_names
        for name, got in run["got"].items():
            ref = run["ref"][name]
            assert got["replicated"], name
            assert torch.equal(got["y"], ref["y"]) and torch.equal(got["dx"], ref["dx"]), name
            if got["dmem"] is not None:
                assert torch.equal(got["dmem"], ref["dmem"]), name
            assert got["grads"].keys() == ref["grads"].keys()
            assert all(torch.equal(g, ref["grads"][k]) for k, g in got["grads"].items()), name


@pytest.mark.parametrize("case", CASES)
def test_tp_launches_per_rank_equal_the_closed_form(tp4, case):
    cfg = workers.uneven_config(case, "pallas")
    want = _chip_smoke().lm_train_launches(cfg, model_axis=M)
    for r in tp4:
        assert r["steps"][(case, "pallas")]["launches"] == want
        assert r["steps"][(case, "fake_quant")]["launches"] == {}


@pytest.mark.parametrize("case", CASES)
def test_tp_step_matches_jax_unsharded_loss_and_grads(tp4, jax_ref, case):
    ref = jax_ref[case]
    for rank, r in enumerate(tp4):
        s = r["jax"][case]
        assert abs(s["loss"].item() - ref["loss"]) <= 1e-4 * abs(ref["loss"])
        for k, g in s["grads"].items():
            want = ref["grads"][k]
            if k in s["layout"]:
                want = s["layout"][k].take(want, rank)
            assert _rel(g, want) <= 1e-4, k


@pytest.mark.parametrize("case,backend", STEPS, ids=lambda v: str(v))
def test_serving_matches_the_unsharded_engine_at_model_4(tp4, case, backend):
    cfg = workers.uneven_config(case, backend)
    ranks = [r["serve"][(case, backend)] for r in tp4]
    for c in ranks:
        assert c["logits"].shape[-1] == cfg.vocab
        assert _rel(c["logits"], c["ref_logits"]) <= 1e-5
        assert c["cache_exact"]
        for name, exact in c["cache_exact"].items():
            if name in ("ak", "av", "xk", "xv") and backend == "off":  # after row sums
                assert c["cache_rel"][name] <= 1e-6, (name, c["cache_rel"])
            else:
                assert exact, (name, c["cache_rel"])
        for name, (got, spec) in c["cache_shapes"].items():
            assert got == spec, name
    assert all(torch.equal(c["logits"], ranks[0]["logits"]) for c in ranks)
    if case.startswith("attn_") and "k" in ranks[0]["cache_shapes"]:
        assert ranks[0]["cache_shapes"]["k"][0][2] == cfg.n_kv_heads  # every kv head
    if backend == "pallas":
        want = _chip_smoke().serve_launches(cfg, model_axis=M)
        assert all(c["decode_launches"] == {k: n for k, n in want.items() if n}
                   for c in ranks)
    if backend == "off":
        assert all(torch.equal(c["tokens"], c["ref_tokens"]) for c in ranks)


def _full(arch):
    cfg = dataclasses.replace(configs.get_config(arch), quant_backend="pallas")
    return cfg, {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}


def test_full_config_layouts_at_model_16():
    cfg, shapes = _full("yi-34b")
    sixteen = tp_layout(cfg, shapes, 16)
    widths = [b - a for a, b in sixteen["layers.0.attn.wq.w"].bounds]
    assert widths == [4 * 128] * 8 + [3 * 128] * 8
    assert sixteen["layers.0.attn.wo.w"].bounds == sixteen["layers.0.attn.wq.w"].bounds
    assert "layers.0.attn.wk.w" not in sixteen  # 8 kv heads, replicated
    assert kv_map(cfg, 16, 1) == (0, 0, 0, 1)  # heads 4-7 over kv heads of 7
    assert rank_heads(cfg, 16, 1) == (4, 2, (0, 2))
    cfg, shapes = _full("llama4-scout-17b-a16e")
    widths = [b - a for a, b in tp_layout(cfg, shapes, 16)["layers.0.attn.wq.w"].bounds]
    assert widths == [3 * 128] * 8 + [2 * 128] * 8
    cfg, shapes = _full("seamless-m4t-medium")
    sixteen = tp_layout(cfg, shapes, 16)
    assert not any(".attn." in k or ".xattn." in k for k in sixteen)
    assert "emb" not in sixteen and "lm_head" not in sixteen
    assert "layers.0.mlp.w_up.w" in sixteen and "enc_layers.0.mlp.w_down.w" in sixteen
    three = tp_layout(cfg, shapes, 3)
    assert [b - a for a, b in three["layers.0.attn.wq.w"].bounds] == [384, 384, 256]
    cfg, shapes = _full("zamba2-7b")
    for m in (8, 16):
        layout = tp_layout(cfg, shapes, m)
        assert not any(k.startswith("shared_attn.attn.") for k in layout)
        assert "shared_attn.mlp.w_up.w" in layout and "emb" in layout
    cfg, shapes = _full("mamba2-370m")
    assert "emb" not in tp_layout(cfg, shapes, 16)
    assert "emb" in tp_layout(cfg, shapes, 8)


def test_split_k1_and_k3_launch_specs_prove_at_yi_34b_uneven_heads():
    from repro_torch.analysis.kernel_verify import (
        TP_AUDIT_UNEVEN, tensor_parallel_specs, verify_specs)

    arch, m, tokens = TP_AUDIT_UNEVEN
    specs = tensor_parallel_specs(configs.get_config(arch), m, tokens)
    report = verify_specs("tp", specs)
    assert report.ok, report.first_violation()
    quantized = {s.operands[0].shape for s, _ in specs if s.kernel.startswith("quantize_groups")}
    # wq's w^T on rank 0 and rank 15, wo's x (4096 tokens) on both
    assert {(512, 7168), (384, 7168), (4096, 512), (4096, 384)} <= quantized
    # K3: wq's forward over rank 0's 512 and rank 15's 384 columns, wo's over
    # their 4 and 3 groups of rows
    gemms = {(s.operands[0].shape, s.operands[2].shape) for s, _ in specs
             if s.kernel.startswith("mls_matmul")}
    assert {((4096, 7168), (7168, 512)), ((4096, 7168), (7168, 384)),
            ((4096, 512), (512, 7168)), ((4096, 384), (384, 7168))} <= gemms
