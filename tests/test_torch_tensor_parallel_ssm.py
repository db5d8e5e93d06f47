"""Tensor parallelism over the ``model`` axis for the ssm and hybrid
families (``repro_torch.parallel.tensor``: Mamba2 layers split by heads,
the in_proj's tail on rank 0, the hybrid's shared block by the dense
rules) on worlds of gloo processes on the CPU, against the unsharded port
and the JAX package's unsharded ``lm_loss``.

The models are mamba2-370m's and zamba2-7b's smoke configs widened as the
launcher widens them under ``--model-axis`` (``launch.train.tp_smoke``:
d_model 256, a din of 512 = 4 scaling groups of 16 heads of 32, an in_proj
N of 1072 whose tail [1024, 1072) ends in a ragged 48-wide group; the
hybrid's attention 128-wide heads, 2 kv heads, d_ff 640), fp32,
unquantized, on the fake-quant backend and on the quantized one (K1/K3's
plain versions), stochastic rounding from one key.

- World 2, model 2, each arch and backend: in_proj (column-parallel over
  its pieces z, x and, on rank 0, the tail) gives the unsharded linear's
  output pieces and weight-gradient pieces bit for bit, and its data
  gradient (all-reduced) within ``(G_r + 1) eps max|ref|``, ``G_r`` the
  rank's groups of 128 (unquantized: its products); out_proj is a row-parallel linear (its data and
  weight gradient slices bit for bit, its output within the same bound).
  The in_proj's operands of several pieces (the error along N with the
  ragged dt group on rank 0, on K1's split path as qd_gemm pads it; w^T
  along its rows; both on the fake-quant quantizer, whose error is one
  ragged group a row shared over the ranks) equal the slices of the
  unsharded operands' codes, group scales and tensor scale.
- The whole step at model 2 (each arch) and at model 4 (mamba2) against
  the unsharded port: the loss within 1e-6 relative and each gradient
  slice within 1e-5 relative in the L2 norm, on every backend; the
  quantized one's launches per rank equal
  ``chip_smoke.lm_train_launches(cfg, model_axis=m)``.  The quantized
  steps feed each linear the unsharded step's input and output gradient
  (this rank's part; ``torch_dist_workers._linear_feed``): a row-parallel
  sum differs from the unsharded one by an ulp in its order, and where
  that moves a stochastic-rounding code of the next operand the step
  moves by the code (the hybrid, unfed: loss 1.5e-5 to 2.7e-5 relative at
  5 layers, the emb gradient 3.7% at 3), which no split can avoid.
- The unquantized step on the JAX package's parameters against the JAX
  package's unsharded ``lm_loss`` and ``jax.grad``: within 1e-4.
- World 4 = data 2 x model 2: two steps of ``launch.train.main
  --model-axis 2`` (HSDP over the data axis) equal two microbatch-2 steps
  of the model-only world 2 on the same global batch (losses and
  parameters within 1e-6).
- ``tp_layout`` of the full configs on group and head boundaries, the
  tail [2 din, N) on rank 0; K1's split entries' launch specs proved at
  zamba2-7b's rank shapes (``tests/test_torch_tensor_parallel_serve.py``
  serves a tensor-parallel model).
"""
import dataclasses
import importlib.util
import math
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
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.core.lowbit import Sharded  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.parallel.tensor import (  # noqa: E402
    TAIL_RANK, Split, mamba_heads, tp_layout)

EPS = float(np.finfo(np.float32).eps)
ARCHS = workers.SSM_ARCHS


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
        over = {k: getattr(cfg, k) for k in ("d_model", "ssm_headdim", "head_dim",
                                             "n_kv_heads", "d_ff")}
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
    return workers.run_world(workers.ssm_tp2_worker, 2,
                             {a: r["state"] for a, r in jax_ref.items()})


@pytest.fixture(scope="module")
def tp4():
    return workers.run_world(workers.ssm_tp4_worker, 4)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _take(pieces, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return Split(dim % t.ndim, (tuple(pieces),)).take(t, 0)


LINEARS = [(arch, backend, name) for arch in ARCHS for backend in workers.TP_BACKENDS
           for name in ("in_proj", "out_proj")]


@pytest.mark.parametrize("arch,backend,name", LINEARS, ids=lambda v: str(v))
def test_in_and_out_proj_match_unsharded_slices(tp2, arch, backend, name):
    for rank, r in enumerate(tp2):
        (y, dx, dw), (yt, dxt, dwt, pieces) = r["linears"][(arch, backend, name)]
        if rank == TAIL_RANK and name == "in_proj":
            assert pieces[-1] == (1024, 1072) and len(pieces) == 3
        width = 1 if backend == "off" else 128  # unquantized: each product its own group
        groups = sum(-(-(b - a) // width) for a, b in pieces)
        if name == "in_proj":  # column-parallel over its pieces
            assert torch.equal(yt, _take(pieces, y)) and torch.equal(dwt, _take(pieces, dw))
            summed, ref = dxt, dx
        else:  # row-parallel
            assert torch.equal(dxt, _take(pieces, dx)) and torch.equal(dwt, _take(pieces, dw, 0))
            summed, ref = yt, y
        tol = (groups + 1) * EPS * ref.abs().max().item()
        assert (summed - ref).abs().max().item() <= tol


@pytest.mark.parametrize("dim", [1, 0], ids=["error_along_n", "weight_rows"])
def test_multi_piece_operands_quantize_as_slices_of_the_unsharded(tp2, dim):
    for rank, r in enumerate(tp2):
        q = r["quantizers"]
        pieces, n = q["pieces"], q["full"]
        assert (rank == TAIL_RANK) == (pieces[-1][1] == n)
        (codes, s_g, s_t), (wc, wsg, wst) = q[dim]["got"], q[dim]["want"]
        if dim == 1:  # the padded contraction: the ragged tail's group ends the dim
            shard = Sharded(1, pieces, n).padded(wc.shape[1])
            assert torch.equal(codes, shard.take(wc, codes.shape[1]))
            gpieces = [(a // 128, -(-b // 128)) for a, b in shard.spans(codes.shape[1])]
            assert torch.equal(s_g, _take(gpieces, wsg))
        else:
            assert torch.equal(codes, _take(pieces, wc, 0))
            assert torch.equal(s_g, _take(pieces, wsg, 0))
        assert torch.equal(s_t, wst)  # the unsharded operand's max, one rank's slice holds it
        (unit, st), (wunit, wst_fq) = q[dim]["fq"], q[dim]["fq_want"]
        assert torch.equal(st, wst_fq)
        assert torch.equal(unit, _take(pieces, wunit, dim))


def _hold_step(s, rank, loss_tol=1e-6, grad_tol=1e-5):
    assert abs(s["loss"].item() - s["ref_loss"].item()) <= loss_tol * abs(s["ref_loss"].item())
    for k, g in s["grads"].items():
        ref = s["ref_grads"][k]
        if k in s["layout"]:
            ref = s["layout"][k].take(ref, rank)
        assert g.shape == ref.shape and _rel(g, ref) <= grad_tol, k


STEPS = [(arch, backend) for arch in ARCHS for backend in workers.TP_BACKENDS]


@pytest.mark.parametrize("arch,backend", STEPS, ids=lambda v: str(v))
def test_tp_step_matches_the_unsharded_port_at_model_2(tp2, arch, backend):
    for rank, r in enumerate(tp2):
        s = r["steps"][(arch, backend)]
        assert {"emb", "layers.0.in_proj.w", "layers.0.A_log", "layers.0.out_norm.gamma"} <= set(
            s["layout"])
        if arch == "zamba2-7b":
            assert "shared_attn.attn.wq.w" in s["layout"]
        _hold_step(s, rank)


@pytest.mark.parametrize("backend", workers.TP_BACKENDS)
def test_mamba2_at_model_4_matches_the_unsharded_port(tp4, backend):
    for rank, r in enumerate(tp4):
        s = r["steps"][backend]
        heads = [sp[0] for sp in s["layout"]["layers.0.A_log"].pieces]
        assert heads == [(0, 4), (4, 8), (8, 12), (12, 16)]  # one unit of 128 a rank
        _hold_step(s, rank)


@pytest.mark.parametrize("arch,model_axis", [("mamba2-370m", 2), ("mamba2-370m", 4),
                                             ("zamba2-7b", 2)])
def test_tp_launches_per_rank_equal_the_closed_form(tp2, tp4, arch, model_axis):
    cfg = workers.smoke_tp_config(arch, "pallas")
    want = _chip_smoke().lm_train_launches(cfg, model_axis=model_axis)
    steps = ([r["steps"][(arch, "pallas")] for r in tp2] if model_axis == 2 else
             [r["steps"]["pallas"] for r in tp4])
    for s in steps:
        assert s["launches"] == want


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
def test_full_config_layout_falls_on_groups_and_heads_with_the_tail_on_rank_0(arch):
    cfg = dataclasses.replace(configs.get_config(arch), quant_backend="pallas")
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    din, hd, n = cfg.d_inner, cfg.ssm_headdim, shapes["layers.0.in_proj.w"][1]
    for m in (2, 8) if arch == "mamba2-370m" else (2,):
        layout = tp_layout(cfg, shapes, m)
        unit = math.lcm(128, hd)
        sp = layout["layers.0.in_proj.w"]
        assert sum(sp.size(r) for r in range(m)) == n
        for r, pieces in enumerate(sp.pieces):
            z, x = pieces[:2]
            assert z[0] % unit == 0 and z[1] % unit == 0 and x == (z[0] + din, z[1] + din)
            assert (pieces[2:] == ((2 * din, n),)) == (r == TAIL_RANK)
            assert layout["layers.0.out_proj.w"].pieces[r] == (z,)
            assert layout["layers.0.out_norm.gamma"].pieces[r] == (z,)
            assert layout["layers.0.A_log"].pieces[r] == ((z[0] // hd, z[1] // hd),)
        covered = sorted(p for ps in sp.pieces for p in ps)
        assert all(a[1] == b[0] for a, b in zip(covered, covered[1:]))
        assert covered[0][0] == 0 and covered[-1][1] == n
        assert (2 * din) % 128 == 0  # the tail starts on a group boundary
        assert mamba_heads(cfg, m)[0] == (0, cfg.ssm_heads // m)
    if arch == "zamba2-7b":
        two = tp_layout(cfg, shapes, 2)
        sp = two["layers.0.in_proj.w"]
        assert (sp.size(0), sp.size(1)) == (7408, 7168)
        assert two["shared_attn.attn.wq.w"].bounds == ((0, 1792), (1792, 3584))  # 14 groups
        assert two["shared_attn.mlp.w_up.w"].bounds == ((0, 7168), (7168, 14336))
    else:
        assert tp_layout(cfg, shapes, 2)["emb"].bounds == ((0, 25140), (25140, 50280))


def test_split_k1_launch_specs_prove_at_zamba2_tensor_parallel_shapes():
    from repro_torch.analysis.kernel_verify import (
        TP_AUDIT_HYBRID, tensor_parallel_specs, verify_specs)

    arch, m, tokens = TP_AUDIT_HYBRID
    specs = tensor_parallel_specs(configs.get_config(arch), m, tokens)
    report = verify_specs("tp", specs)
    assert report.ok, report.first_violation()
    shapes = {s.operands[0].shape for s, _ in specs if s.kernel.startswith("quantize_groups")}
    # rank 0's in_proj w^T and error (the tail's ragged group padded), rank 1's w^T
    assert {(7408, 3584), (4096, 7424), (7168, 3584)} <= shapes
