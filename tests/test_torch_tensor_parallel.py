"""Tensor parallelism over the ``model`` axis (``repro_torch.parallel.tensor``)
on worlds of gloo processes on the CPU, against the unsharded port and the
JAX package's unsharded ``lm_loss``.

The model is chatglm3-6b's smoke config widened as the launcher widens it
under ``--model-axis`` (``launch.train.TP_SMOKE``: 128-wide heads, 2 kv
heads, d_ff 640 = 5 scaling groups, split 384 / 256 at model 2), fp32,
unquantized, on the fake-quant backend and on the quantized one (K1/K3's
plain versions), stochastic rounding from one key.

- World 2, model 2, each backend: every column-parallel linear (w_up, wq)
  gives the unsharded linear's output slice and weight-gradient slice bit
  for bit, and its data gradient (a sum over the split, all-reduced)
  within ``(G_r + 1) eps max|ref|``, ``G_r`` the rank's groups of 128
  (seen: 1.1e-7 of max|ref|); every row-parallel one (w_down, wo) its data
  and weight gradient slices bit for bit and its output within the same
  bound.  The sharded operands' codes, group scales and tensor scale equal
  the slices of the unsharded operand's (``quantize_ref``), on K1's split
  path and on the fake-quant quantizer, sharded on either dim.
- The whole step at model 2 and at model 4 (chatglm3-6b's 2 kv heads
  replicated there, each rank attending with the kv head its query head
  maps to) against the unsharded port: the loss within 1e-6 relative and
  each gradient slice within 1e-5 relative in the L2 norm (seen: 1.7e-6),
  on every backend; the quantized one's launches per rank equal
  ``chip_smoke.lm_train_launches(cfg, model_axis=m)``.  The quantized
  steps feed each linear the unsharded step's input and output gradient
  (this rank's part; ``torch_dist_workers._linear_feed``): a row-parallel
  sum differs from the unsharded one by an ulp in its order, and where
  that moves a stochastic-rounding code of the next operand the step
  moves by the code (unfed, one CPU's order put wo's gradient of layer 1
  4.09e-4 apart at model 2), which no split can avoid.
- The unquantized step on the JAX package's parameters against the JAX
  package's unsharded ``lm_loss`` and ``jax.grad``: within 1e-4, the
  tolerance JAX holds its own (data 2, model 2) mesh to.
- World 4 = data 2 x model 2: two steps of ``launch.train.main
  --model-axis 2`` (HSDP over the data axis) equal two microbatch-2 steps
  of the model-only world 2 on the same global batch (losses within 1e-6,
  parameters within 1e-6; seen equal bit for bit).
- ``--model-axis`` outside ``torchrun`` raises for the moe and encdec
  archs (``tests/test_torch_tensor_parallel_ssm.py``, ``_moe.py`` and
  ``_encdec.py`` hold the other families' tensor parallelism,
  ``_serve.py`` serving a tensor-parallel model of every family, and
  ``_uneven.py`` what the model axis does not divide).
- ``lint_tensor_parallel`` admits every architecture at model axes up to
  16, each case the axis does not divide named in a warning (uneven query
  heads, a replicated attention or vocabulary), and refuses grouping other
  than "nc" and a family not ported.
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
from repro_torch.launch import train as launcher  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.parallel.tensor import tp_layout  # noqa: E402

EPS = float(np.finfo(np.float32).eps)
TP_SMOKE = launcher.TP_SMOKE


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's unquantized config and parameters, its loss and gradients on
    the workers' batch, and the parameters as the port's state dict."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("chatglm3-6b"), **TP_SMOKE,
                               quant=False)
    cfg = workers.tp_config("off")
    params = jlm.init_lm(jax.random.key(0), jcfg)
    batch = {"tokens": jnp.asarray(workers.tp_batch(cfg, 2)["tokens"].numpy())}
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None), has_aux=True))
    (loss, _), grads = fn(params, batch)
    return dict(state=lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
                loss=float(loss), grads=lm_params_from_jax(jax.tree.map(np.asarray, grads), cfg))


@pytest.fixture(scope="module")
def tp2(jax_ref):
    return workers.run_world(workers.tp2_worker, 2, jax_ref["state"])


@pytest.fixture(scope="module")
def tp4():
    return workers.run_world(workers.tp4_worker, 4)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _slice(layout, rank, name, t):
    sp = layout.get(name)
    if sp is None:
        return t
    a, b = sp.bounds[rank]
    return t.narrow(sp.dim, a, b - a)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


LINEARS = [(backend, name, kind) for backend in workers.TP_BACKENDS
           for name, kind, *_ in workers.TP_LINEARS]


@pytest.mark.parametrize("backend,name,kind", LINEARS, ids=lambda v: str(v))
def test_tp_linear_matches_unsharded_slices(tp2, backend, name, kind):
    for r in tp2:
        (y, dx, dw), (yt, dxt, dwt, (a, b)) = r["linears"][(backend, name)]
        groups = -(-(b - a) // 128)
        if kind == "column":
            assert torch.equal(yt, y[..., a:b]) and torch.equal(dwt, dw[:, a:b])
            summed, ref = dxt, dx
        else:
            assert torch.equal(dxt, dx[..., a:b]) and torch.equal(dwt, dw[a:b])
            summed, ref = yt, y
        tol = (groups + 1) * EPS * ref.abs().max().item()
        assert (summed - ref).abs().max().item() <= tol


@pytest.mark.parametrize("dim", [1, 0], ids=["contraction", "rows"])
def test_sharded_operands_quantize_as_slices_of_the_unsharded(tp2, dim):
    for r in tp2:
        q = r["quantizers"][dim]
        a, b = q["take"]
        (codes, s_g, s_t), (wc, wsg, wst) = q["got"], q["want"]
        if dim == 1:
            want = (wc[:, a:b], wsg[:, a // 128:-(-b // 128)])
        else:
            want = (wc[a:b], wsg[a:b])
        assert torch.equal(codes, want[0]) and torch.equal(s_g, want[1])
        assert torch.equal(s_t, wst)  # the unsharded operand's max, one rank's slice holds it
        (unit, st), (wunit, wst_fq) = q["fq"], q["fq_want"]
        assert torch.equal(st, wst_fq)
        assert torch.equal(unit, wunit[:, a:b] if dim == 1 else wunit[a:b])


def _hold_step(s, rank, loss_tol=1e-6, grad_tol=1e-5):
    assert abs(s["loss"].item() - s["ref_loss"].item()) <= loss_tol * abs(s["ref_loss"].item())
    for k, g in s["grads"].items():
        ref = _slice(s["layout"], rank, k, s["ref_grads"][k])
        assert g.shape == ref.shape and _rel(g, ref) <= grad_tol, k


@pytest.mark.parametrize("backend", workers.TP_BACKENDS)
def test_tp_step_matches_the_unsharded_port_at_model_2(tp2, backend):
    for rank, r in enumerate(tp2):
        s = r["steps"][backend]
        assert set(s["layout"]) >= {"emb", "lm_head", "layers.0.attn.wk.w"}
        _hold_step(s, rank)


@pytest.mark.parametrize("backend", workers.TP_BACKENDS)
def test_model_4_replicates_the_kv_heads_and_matches_the_unsharded_port(tp4, backend):
    for rank, r in enumerate(tp4):
        s = r["steps"][backend]
        assert "layers.0.attn.wk.w" not in s["layout"]  # 2 kv heads over 4 ranks
        # 5 groups of 128 over 4 ranks (unquantized: no groups, 160 each)
        want = (((0, 160), (160, 320), (320, 480), (480, 640)) if backend == "off" else
                ((0, 256), (256, 384), (384, 512), (512, 640)))
        assert s["layout"]["layers.0.mlp.w_up.w"].bounds == want
        _hold_step(s, rank)


@pytest.mark.parametrize("model_axis", [2, 4])
def test_tp_launches_per_rank_equal_the_closed_form(tp2, tp4, model_axis):
    want = _chip_smoke().lm_train_launches(workers.tp_config("pallas"), model_axis=model_axis)
    for r in (tp2 if model_axis == 2 else tp4):
        assert r["steps"]["pallas"]["launches"] == want
        assert r["steps"]["fake_quant"]["launches"] == {}


def test_tp_step_matches_jax_unsharded_loss_and_grads(tp2, jax_ref):
    for rank, r in enumerate(tp2):
        s = r["jax"]
        assert abs(s["loss"].item() - jax_ref["loss"]) <= 1e-4 * abs(jax_ref["loss"])
        for k, g in s["grads"].items():
            ref = _slice(s["layout"], rank, k, jax_ref["grads"][k])
            assert _rel(g, ref) <= 1e-4, k


def test_hsdp_times_tp_equals_the_microbatched_model_only_step(tp2, tp4):
    for r in tp4:
        data, model = r["coord"]
        ref = tp2[model]["microbatch"]
        assert r["world"] == 4
        assert np.allclose(r["losses"], ref["losses"], rtol=0, atol=1e-6)
        for k, p in ref["params"].items():
            assert (r["params"][k] - p).abs().max().item() <= 1e-6, k


def test_layout_follows_param_shardings_in_whole_groups_and_heads():
    cfg = configs.get_config("chatglm3-6b")
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    two = tp_layout(dataclasses.replace(cfg, quant_backend="pallas"), shapes, 2)
    assert two["layers.0.mlp.w_up.w"].bounds == ((0, 6912), (6912, 13696))  # 54 / 53 groups
    assert two["layers.0.mlp.w_down.w"].dim == 0 and two["layers.0.mlp.w_up.w"].dim == 1
    assert two["layers.0.attn.wk.w"].bounds == ((0, 128), (128, 256))
    assert two["layers.0.attn.wq.b"].bounds == ((0, 2048), (2048, 4096))
    assert two["emb"].bounds == ((0, 32512), (32512, 65024)) and two["emb"].dim == 0
    four = tp_layout(cfg, shapes, 4)
    assert "layers.0.attn.wk.w" not in four and "layers.0.attn.wk.b" not in four
    assert not any(k.endswith(("gamma", "beta")) for k in two)


@pytest.mark.parametrize("arch,model_axis,ok", [
    ("chatglm3-6b", 2, True), ("chatglm3-6b", 16, True), ("qwen2-72b", 8, True),
    ("yi-34b", 8, True), ("yi-34b", 16, True), ("pixtral-12b", 16, True),
    ("mamba2-370m", 2, True), ("mamba2-370m", 8, True), ("mamba2-370m", 16, True),
    ("zamba2-7b", 2, True), ("zamba2-7b", 8, True), ("zamba2-7b", 16, True),
    ("moonshot-v1-16b-a3b", 2, True), ("llama4-scout-17b-a16e", 8, True),
    ("seamless-m4t-medium", 2, True), ("seamless-m4t-medium", 4, True)])
def test_lint_tensor_parallel(arch, model_axis, ok):
    res = lint_tensor_parallel(configs.get_config(arch), model_axis)
    assert res.ok == ok, res.errors
    if arch == "chatglm3-6b" and model_axis == 16:
        assert any("kv heads stay replicated" in w for w in res.warnings)
        assert any("896 / 768" in w for w in res.warnings)
    if arch in ("mamba2-370m", "zamba2-7b") and ok:
        tail = "[4096, 4384)" if arch == "mamba2-370m" else "[14336, 14576)"
        assert any(f"in_proj's tail {tail}" in w for w in res.warnings), res.warnings
    if arch == "yi-34b" and model_axis == 16:  # 56 heads: 4 on 8 ranks, 3 on 8
        assert "query heads split unevenly in whole units: 4 / 3" in res.warnings
    if arch == "mamba2-370m" and model_axis == 16:
        assert ("a vocabulary of 50280 stays replicated over a model axis of 16"
                in res.warnings), res.warnings
    if arch == "zamba2-7b" and model_axis >= 8:  # 4 units of 8 heads of 112
        assert (f"attention heads of 112 do not split in whole scaling groups over "
                f"{model_axis} ranks: the attention stays replicated" in res.warnings)
    if arch in ("moonshot-v1-16b-a3b", "llama4-scout-17b-a16e"):
        e = configs.get_config(arch).n_experts
        assert any(f"{e // model_axis} of {e} experts a rank" in w for w in res.warnings)
    if arch == "seamless-m4t-medium" and model_axis == 4:
        assert ("a vocabulary of 256206 stays replicated over a model axis of 4"
                in res.warnings), res.warnings


@pytest.mark.parametrize("what", ["grouping", "family"])
def test_lint_tensor_parallel_refuses_what_cannot_run(what):
    cfg = configs.get_config("chatglm3-6b")
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if what == "family":
        res = lint_tensor_parallel(dataclasses.replace(cfg, family="vision"), 2)
        assert not res.ok and "vision" in res.errors[0], res.errors
        return

    @dataclasses.dataclass(frozen=True)
    class ColumnGroups(type(cfg)):
        def qcfg(self):
            return dataclasses.replace(super().qcfg(), grouping="c")

    res = lint_tensor_parallel(ColumnGroups(**fields), 16)
    assert not res.ok and "grouping 'nc', not 'c'" in res.errors[0], res.errors


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "llama4-scout-17b-a16e",
                                  "seamless-m4t-medium"])
def test_a_model_axis_outside_torchrun_raises(arch, monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        launcher.main(["--arch", arch, "--smoke", "--device", "cpu", "--model-axis", "2"])


def test_split_k1_launch_specs_prove_at_chatglm3_tensor_parallel_shapes():
    from repro_torch.analysis.kernel_verify import TP_AUDIT, tensor_parallel_specs, verify_specs

    arch, m, tokens = TP_AUDIT
    specs = tensor_parallel_specs(configs.get_config(arch), m, tokens)
    report = verify_specs("tp", specs)
    assert report.ok, report.first_violation()
    kernels = {s.kernel for s, _ in specs}
    assert {"quantize_amax", "quantize_partials_max", "quantize_groups_warp"} <= kernels
    assert any(s.shape == (1,) and s.kernel == "quantize_partials_max" for s, _ in specs)
