"""Tensor parallelism over the ``model`` axis for the moe family
(``repro_torch.parallel.tensor``: the expert stacks split in whole experts,
``expert -> model`` as in JAX; the router replicated; the experts' outputs
gathered whole by an all-reduce to which the other ranks send zeros; the
shared expert and the attention by the dense rules) on worlds of gloo
processes on the CPU, against the unsharded port and the JAX package's
unsharded ``lm_loss``.

The models are moonshot-v1-16b-a3b's smoke config (4 experts, top 2) and
llama4-scout-17b-a16e's (top 1 and a shared expert) widened as the
launcher widens them under ``--model-axis`` (``launch.train.tp_smoke``:
128-wide heads, 2 kv heads, moe_d_ff 640 = 5 scaling groups), fp32,
unquantized, on the fake-quant backend and on the quantized one (K1/K3's
plain versions for the attention and the shared expert; the routed
experts run the fake-quant stack on every backend, as in JAX), stochastic
rounding from one key.

- World 2, model 2, layer 0's MoE on one seeded input and output
  gradient, each arch and backend: each rank's expert outputs and weight
  gradients are the unsharded stack's slices bit for bit, and the
  buffer's gradient (summed over the group, the other ranks adding zeros)
  and the gathered outputs ``ye`` the unsharded ones bit for bit; the aux
  loss and the router's gradient are bit for bit on every rank, and so
  are the layer's output and input gradient without a shared expert.
  With one, they differ by the shared expert's sums over the split:
  within ``(G_r + 1) eps max|ref|``, ``G_r`` the rank's groups of 128.
- The whole step at model 2 (each arch) and at model 4 (moonshot: one of
  its 4 experts a rank) against the unsharded port: the loss within 1e-6
  relative and each gradient slice within 1e-5 relative in the L2 norm,
  on every backend; the quantized one's launches per rank equal
  ``chip_smoke.lm_train_launches(cfg, model_axis=m)``.  The quantized
  steps feed each linear, and each MoE layer, the unsharded step's input
  and output gradient (``torch_dist_workers._linear_feed``): a
  row-parallel sum's order can move a stochastic-rounding code (or a
  near-tie of the router) downstream.
- The unquantized step on the JAX package's parameters against the JAX
  package's unsharded ``lm_loss`` and ``jax.grad``: within 1e-4.
- World 4 = data 2 x model 2: two steps of ``launch.train.main
  --model-axis 2`` (HSDP over the data axis) equal two microbatch-2 steps
  of the model-only world 2 on the same global batch (losses and
  parameters within 1e-6).
- ``tp_layout`` of the full configs (moonshot's 64 experts as 32 a rank,
  llama4-scout's 16 as 8 with the shared expert's d_ff of 8192 split in
  whole groups; stacks the axis does not divide stay replicated); K1's
  split entries and K3 proved at moonshot's rank shapes
  (``tests/test_torch_tensor_parallel_serve.py`` serves a tensor-parallel
  MoE model).
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
from repro_torch.parallel.tensor import tp_layout  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
ARCHS = workers.MOE_ARCHS
STACKS = ("w_gate", "w_up", "w_down")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """Per arch: JAX's unquantized loss and gradients on the workers' batch
    and its parameters, each as the port's state dict."""
    out = {}
    for arch in ARCHS:
        cfg = workers.smoke_tp_config(arch, "off")
        over = {k: getattr(cfg, k) for k in ("head_dim", "n_kv_heads", "d_ff", "moe_d_ff")}
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over, quant=False)
        params = jlm.init_lm(jax.random.key(0), jcfg)
        batch = {"tokens": jnp.asarray(workers.tp_batch(cfg, 2)["tokens"].numpy())}
        fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None),
                                        has_aux=True))
        (loss, _), grads = fn(params, batch)
        out[arch] = dict(state=lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
                         loss=float(loss),
                         grads=lm_params_from_jax(jax.tree.map(np.asarray, grads), cfg))
    return out


@pytest.fixture(scope="module")
def tp2(jax_ref):
    return workers.run_world(workers.moe_tp2_worker, 2,
                             {a: r["state"] for a, r in jax_ref.items()})


@pytest.fixture(scope="module")
def tp4():
    return workers.run_world(workers.moe_tp4_worker, 4)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


CASES = [(arch, backend) for arch in ARCHS for backend in workers.TP_BACKENDS]


@pytest.mark.parametrize("arch,backend", CASES, ids=lambda v: str(v))
def test_expert_stack_gives_the_unsharded_slices_and_gather_bit_for_bit(tp2, arch, backend):
    cfg = workers.smoke_tp_config(arch, backend)
    for rank, r in enumerate(tp2):
        ref, got = r["layers"][(arch, backend)]
        e0, e1 = got["experts"]
        assert (e0, e1) == ((0, 2), (2, 4))[rank] and ref["experts"] is None
        assert torch.equal(got["local"], ref["local"][e0:e1])  # this rank's experts
        for k in STACKS:
            assert torch.equal(got["grads"][k], ref["grads"][k][e0:e1]), k
        assert torch.equal(got["ye"], ref["ye"])  # the gather
        assert torch.equal(got["xe_grad"], ref["xe_grad"])  # the buffer's summed gradient
        assert torch.equal(got["aux"], ref["aux"])
        assert torch.equal(got["grads"]["router.w"], ref["grads"]["router.w"])
        if not cfg.n_shared_experts:
            assert torch.equal(got["y"], ref["y"]) and torch.equal(got["dx"], ref["dx"])
            continue
        # the rank's groups of 128 (unquantized: each product its own)
        groups = 3 if backend != "off" else cfg.moe_d_ff // 2
        for what in ("y", "dx"):  # the shared expert's row- and column-parallel sums
            tol = (groups + 1) * EPS * ref[what].abs().max().item()
            assert (got[what] - ref[what]).abs().max().item() <= tol, what
    assert torch.equal(tp2[0]["layers"][(arch, backend)][1]["y"],
                       tp2[1]["layers"][(arch, backend)][1]["y"])  # every rank's output


def _hold_step(s, rank, loss_tol=1e-6, grad_tol=1e-5):
    assert abs(s["loss"].item() - s["ref_loss"].item()) <= loss_tol * abs(s["ref_loss"].item())
    for k, g in s["grads"].items():
        ref = s["ref_grads"][k]
        if k in s["layout"]:
            ref = s["layout"][k].take(ref, rank)
        assert g.shape == ref.shape and _rel(g, ref) <= grad_tol, k


@pytest.mark.parametrize("arch,backend", CASES, ids=lambda v: str(v))
def test_tp_step_matches_the_unsharded_port_at_model_2(tp2, arch, backend):
    for rank, r in enumerate(tp2):
        s = r["steps"][(arch, backend)]
        assert {"emb", "layers.0.attn.wq.w", "layers.0.moe.w_gate", "layers.1.moe.w_down"} <= set(
            s["layout"])
        assert "layers.0.moe.router.w" not in s["layout"]
        if arch == "llama4-scout-17b-a16e":  # 5 groups of 128 (unquantized: even)
            want = ((0, 320), (320, 640)) if backend == "off" else ((0, 384), (384, 640))
            assert s["layout"]["layers.0.moe.shared.w_up.w"].bounds == want
        _hold_step(s, rank)


@pytest.mark.parametrize("backend", workers.TP_BACKENDS)
def test_moe_at_model_4_one_expert_a_rank_matches_the_unsharded_port(tp4, backend):
    for rank, r in enumerate(tp4):
        s = r["steps"][backend]
        assert s["layout"]["layers.0.moe.w_up"].bounds == ((0, 1), (1, 2), (2, 3), (3, 4))
        assert "layers.0.attn.wk.w" not in s["layout"]  # 2 kv heads over 4 ranks
        _hold_step(s, rank)


@pytest.mark.parametrize("arch,model_axis", [(ARCHS[0], 2), (ARCHS[0], 4), (ARCHS[1], 2)])
def test_tp_launches_per_rank_equal_the_closed_form(tp2, tp4, arch, model_axis):
    cfg = workers.smoke_tp_config(arch, "pallas")
    want = _chip_smoke().lm_train_launches(cfg, model_axis=model_axis)
    steps = ([r["steps"][(arch, "pallas")] for r in tp2] if model_axis == 2 else
             [r["steps"]["pallas"] for r in tp4])
    for s in steps:
        assert s["launches"] == want
    for r in tp2:
        assert r["steps"][(arch, "fake_quant")]["launches"] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_matches_jax_unsharded_loss_and_grads(tp2, jax_ref, arch):
    ref = jax_ref[arch]
    for rank, r in enumerate(tp2):
        s = r["jax"][arch]
        assert abs(s["loss"].item() - ref["loss"]) <= 1e-4 * abs(ref["loss"])
        for k, g in s["grads"].items():
            want = ref["grads"][k]
            if k in s["layout"]:
                want = s["layout"][k].take(want, rank)
            assert _rel(g, want) <= 1e-4, k


@pytest.mark.parametrize("arch", ARCHS)
def test_hsdp_times_tp_equals_the_microbatched_model_only_step(tp2, tp4, arch):
    for r in tp4:
        data, model = r["coord"]
        got, ref = r["launcher"][arch], tp2[model]["microbatch"][arch]
        assert got["world"] == 4
        assert np.allclose(got["losses"], ref["losses"], rtol=0, atol=1e-6)
        for k, p in ref["params"].items():
            assert (got["params"][k] - p).abs().max().item() <= 1e-6, k


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_layout_splits_whole_experts(arch):
    cfg = dataclasses.replace(configs.get_config(arch), quant_backend="pallas")
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    two = tp_layout(cfg, shapes, 2)
    e = cfg.n_experts
    for k in STACKS:
        sp = two[f"layers.0.moe.{k}"]
        assert sp.dim == 0 and sp.bounds == ((0, e // 2), (e // 2, e))
    assert "layers.0.moe.router.w" not in two
    if arch == "llama4-scout-17b-a16e":  # the shared expert: 64 groups of 128, 32 a rank
        assert two["layers.0.moe.shared.w_up.w"].bounds == ((0, 4096), (4096, 8192))
        assert two["layers.0.moe.shared.w_down.w"].dim == 0
        assert two["emb"].bounds == ((0, 101024), (101024, 202048))
        eight = tp_layout(cfg, shapes, 8)
        assert eight["layers.0.moe.w_gate"].bounds[7] == (14, 16)
        assert eight["layers.0.attn.wk.w"].bounds[1] == (128, 256)  # one kv head a rank
    else:
        assert two["layers.0.attn.wq.w"].bounds == ((0, 1024), (1024, 2048))
    # experts the axis does not divide stay replicated (JAX's spec_for drops the axis)
    odd = dataclasses.replace(cfg, n_experts=e - 1)
    shapes = {k: tuple(t.shape) for k, t in abstract_params(odd).items()}
    assert not any(".moe.w_" in k for k in tp_layout(odd, shapes, 2))
    res = lint_tensor_parallel(odd, 2)
    assert res.ok and any("stay replicated" in w for w in res.warnings), res.warnings


def test_split_k1_and_k3_launch_specs_prove_at_moonshot_tensor_parallel_shapes():
    from repro_torch.analysis.kernel_verify import (
        TP_AUDIT_MOE, tensor_parallel_specs, verify_specs)

    arch, m, tokens = TP_AUDIT_MOE
    specs = tensor_parallel_specs(configs.get_config(arch), m, tokens)
    report = verify_specs("tp", specs)
    assert report.ok, report.first_violation()
    kernels = {s.kernel for s, _ in specs}
    assert {"quantize_amax", "quantize_partials_max", "quantize_groups_warp"} <= kernels
    assert any(k.startswith("mls_matmul") for k in kernels)
    shapes = {s.operands[0].shape for s, _ in specs if s.kernel.startswith("quantize_groups")}
    # the attention's w^T (1024 of 2048 columns a rank) and the errors of 4096 tokens
    assert {(1024, 2048), (4096, 1024)} <= shapes
