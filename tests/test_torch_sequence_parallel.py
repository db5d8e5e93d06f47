"""Sequence parallelism over the ``model`` axis (``tensor_parallel(...,
seq_shard=True)``, the port of JAX's ``SP_RULES``) on worlds of gloo
processes on the CPU, against the DEFAULT tensor-parallel step, the
unsharded port and the JAX package's unsharded ``lm_loss``.

The models are every LM family's smoke config widened as the launcher
widens it under ``--model-axis`` (``torch_dist_workers.serve_config``),
fp32, unquantized, on the fake-quant backend and on the quantized one
(K1/K3's plain versions), stochastic rounding from one key, 2 rows of 16
tokens (the encoder-decoder's over 12 frames).

- The conjugate collectives: ``gather_seq`` (all-gather forward,
  reduce-scatter backward) and ``scatter_seq`` (the other way round) equal
  their closed forms on every rank.
- World 2, model 2, every family and backend: the SP step's loss and every
  model-split parameter's gradient equal the DEFAULT step's bit for bit
  (two partials add the same in an all-reduce and in a reduce-scatter),
  and the replicated parameters' gradients, summed over the group from
  each rank's tokens, within 1e-6 relative (seen: 1.5e-7); the launches
  per rank are the DEFAULT step's closed form.  Against the unsharded
  port (quantized steps fed each linear's and MoE layer's unsharded
  operands, their rank's tokens, ``torch_dist_workers._linear_feed``):
  the loss within 1e-6 relative, every gradient within 1e-5 (seen:
  6.2e-6).  A prefill under SP gives the DEFAULT prefill's logits and
  caches bit for bit.
- A linear kept whole run on a rank's 128 of 256 tokens
  (``LinearSplit.tokens``): its outputs and data gradient are the
  unsharded rows bit for bit on both quantized backends, its weight
  gradients summed over the ranks within ``(G + 1) eps max|ref|`` (``G``
  the scaling groups of the contraction); its operands quantize as token
  slices of the unsharded ones on K1's split entries and on the fake-quant
  quantizer.
- World 4, model 4, ``UNEVEN_CASES`` (the quantized backend over 512
  tokens, 128 a rank, whole scaling groups for the token slices): the SP
  step against the unsharded port, the loss within 1e-6 and the gradients
  within 2e-5 relative (the DEFAULT layout's own gap on these Mamba2
  ``dt_bias`` / ``A_log`` gradients reaches 1.48e-5 on this batch; seen
  here: 1.2e-5), the quantized launches per rank the closed form (a
  linear on a rank's tokens launches as a column-parallel one).  Each attention kept whole, run on the rank's tokens
  under SP with nearest rounding: its outputs are the unsharded rows bit
  for bit; its data gradients are the unsharded rows bit for bit where
  they do not pass through K/V (a cross-attention's queries) and, on fp32
  and fake-quant, within 1e-6 relative where they do (every rank's
  queries add into K/V's gradient, in another order than the unsharded
  einsum; on K1/K3 that order can move a code of K/V's quantized error,
  which the fed steps hold instead); its weight gradients summed over the
  ranks within 1e-6 relative (on K1/K3, ``wq``'s and ``wo``'s).
- World 4, model 4: the SP step on the JAX package's parameters of its own
  SP test's config (glm4-9b smoke, unquantized, 4 query and 4 kv heads)
  against the JAX package's unsharded ``lm_loss`` and ``jax.grad``: within
  1e-4.
- ``lint_tensor_parallel(..., seq_shard=True)`` names what runs on each
  rank's own tokens and a sequence that stays whole.
- The dry run's counter takes ``gather_seq`` and ``scatter_seq`` (on a fake
  world) at JAX's ring formulas: an all-gather moves ``out (g - 1) / g``,
  a reduce-scatter ``out (g - 1)``, on the model dim.
"""
import contextlib
import dataclasses
import functools
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
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.launch.trace_counts import StepCounter, mesh_dims  # noqa: E402
from repro_torch.parallel.tensor import (  # noqa: E402
    SeqShard, TensorParallel, gather_seq, scatter_seq, seq_unit)

EPS = float(np.finfo(np.float32).eps)
STEPS = [(arch, backend) for arch in workers.SP_ARCHS for backend in workers.TP_BACKENDS]
UNEVEN = [(case, backend) for case in workers.UNEVEN_CASES for backend in workers.TP_BACKENDS]
ATTN = [(case, backend) for case, backend in UNEVEN if case.startswith("attn_")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def worlds(request):
    """The two worlds side by side: the world of 2 started first, the world
    of 4 once the JAX reference it runs on is ready.  A function of the
    world's name that waits for its result; both are joined at the end in
    any case."""
    started, done = {"sp2": workers.start_world(workers.sp2_worker, 2)}, {}

    def result(name):
        if name not in done:
            try:
                done[name] = (workers.finish_world(started[name]), None)
            except Exception as err:  # noqa: BLE001 - raised to every test of the world
                done[name] = (None, err)
        out, err = done[name]
        if err is not None:
            raise err
        return out

    try:
        state = request.getfixturevalue("jax_ref")["state"]
        started["sp4"] = workers.start_world(workers.sp4_worker, 4, state)
        yield result
    finally:
        for name in started:  # a world's fault is raised to the tests that use it
            with contextlib.suppress(Exception):
                result(name)


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's SP test config's parameters, its unsharded loss and gradients
    on the workers' batch, and the parameters as the port's state dict."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("glm4-9b"), quant=False, n_heads=4,
                               n_kv_heads=4)
    cfg = workers.sp_jax_config()
    params = jlm.init_lm(jax.random.key(0), jcfg)
    batch = {"tokens": jnp.asarray(workers.sp_batch(cfg)["tokens"].numpy())}
    fn = jax.jit(jax.value_and_grad(lambda p, b: jlm.lm_loss(p, b, jcfg, None), has_aux=True))
    (loss, _), grads = fn(params, batch)
    return dict(state=lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
                loss=float(loss), grads=lm_params_from_jax(jax.tree.map(np.asarray, grads), cfg))


@pytest.fixture(scope="module")
def sp2(worlds):
    return worlds("sp2")


@pytest.fixture(scope="module")
def sp4(worlds):
    return worlds("sp4")


@functools.cache
def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _hold_step(s, rank, loss_tol=1e-6, grad_tol=1e-5):
    assert abs(s["loss"].item() - s["ref_loss"].item()) <= loss_tol * abs(s["ref_loss"].item())
    for k, g in s["grads"].items():
        ref = s["ref_grads"][k]
        if k in s["layout"]:
            ref = s["layout"][k].take(ref, rank)
        assert g.shape == ref.shape and _rel(g, ref) <= grad_tol, k


def test_gather_and_scatter_seq_equal_their_closed_forms(sp2):
    cs = [r["collectives"] for r in sp2]
    n = cs[0]["x"].shape[1]
    whole = torch.cat([c["x"] for c in cs], dim=1)
    for rank, c in enumerate(cs):
        mine = slice(rank * n, (rank + 1) * n)
        assert torch.equal(c["y"], whole)  # all-gather along the sequence
        assert torch.equal(c["dx"], sum(d["gy"] for d in cs)[:, mine])  # its reduce-scatter
        assert torch.equal(c["z"], sum(d["p"] for d in cs)[:, mine])  # reduce-scatter
        assert torch.equal(c["dp"], torch.cat([d["gz"] for d in cs], dim=1))  # its all-gather


@pytest.mark.parametrize("arch,backend", STEPS, ids=lambda v: str(v))
def test_sp_step_equals_the_default_step_at_model_2(sp2, arch, backend):
    cfg = workers.serve_config(arch, backend)
    want = _chip_smoke().lm_train_launches(cfg, model_axis=2) if backend == "pallas" else {}
    for r in sp2:
        s = r["steps"][(arch, backend)]
        d, p = s["default"], s["sp"]
        assert p["seq_split"] == {"dec": True, "enc": cfg.family == "encdec"}
        assert torch.equal(p["loss"], d["loss"])
        for k, g in d["grads"].items():
            if k in d["layout"]:
                assert torch.equal(p["grads"][k], g), k
            else:
                assert _rel(p["grads"][k], g) <= 1e-6, k
        assert p["launches"] == d["launches"] == want


@pytest.mark.parametrize("arch,backend", STEPS, ids=lambda v: str(v))
def test_sp_step_matches_the_unsharded_port_at_model_2(sp2, arch, backend):
    for rank, r in enumerate(sp2):
        _hold_step(r["steps"][(arch, backend)]["fed"], rank)


@pytest.mark.parametrize("arch,backend", [(a, b) for a in workers.SP_ARCHS
                                          for b in ("off", "pallas")], ids=lambda v: str(v))
def test_prefill_under_sp_equals_the_default_prefill(sp2, arch, backend):
    for r in sp2:
        d, p = r["prefill"][(arch, backend)]["default"], r["prefill"][(arch, backend)]["sp"]
        assert torch.equal(p["logits"], d["logits"])
        assert d["cache"].keys() == p["cache"].keys()
        assert all(torch.equal(p["cache"][k], d["cache"][k]) for k in d["cache"])


@pytest.mark.parametrize("backend", workers.TP_BACKENDS[1:])
def test_token_split_linear_is_the_unsharded_rows(sp2, backend):
    cases = [r["linear"][backend] for r in sp2]
    b, s, _, _ = workers.SP_LINEAR
    (y, dx, dw), groups = cases[0]["ref"], -(-b * s // 128)
    for c in cases:
        a, n = c["start"], c["n"]
        yt, dxt, _ = c["got"]
        assert torch.equal(yt, y[:, a:a + n]) and torch.equal(dxt, dx[:, a:a + n])
    summed = sum(c["got"][2] for c in cases)
    assert (summed - dw).abs().max().item() <= (groups + 1) * EPS * dw.abs().max().item()
    for c in cases:  # the operands alone: rows of the unsharded operand's quantization
        a, n = c["start"], c["n"]
        rows = torch.cat([torch.arange(i * s + a, i * s + a + n) for i in range(b)])
        (codes, s_g, s_t), (wc, wsg, wst) = c["k1"]
        assert torch.equal(codes, wc[rows]) and torch.equal(s_g, wsg[rows])
        assert torch.equal(s_t, wst)  # the max over every rank's tokens
        (unit, st), (wunit, wst_fq) = c["fake_quant"]
        assert torch.equal(st, wst_fq) and torch.equal(unit, wunit[:, a:a + n])


def test_sp_step_matches_jax_unsharded_loss_and_grads(sp4, jax_ref):
    for rank, r in enumerate(sp4):
        s = r["jax"]
        assert s["seq_split"]["dec"]
        assert abs(s["loss"].item() - jax_ref["loss"]) <= 1e-4 * abs(jax_ref["loss"])
        for k, g in s["grads"].items():
            ref = jax_ref["grads"][k]
            if k in s["layout"]:
                ref = s["layout"][k].take(ref, rank)
            assert g.shape == ref.shape and _rel(g, ref) <= 1e-4, k


@pytest.mark.parametrize("case,backend", UNEVEN, ids=lambda v: str(v))
def test_sp_step_matches_the_unsharded_port_at_model_4(sp4, case, backend):
    cfg = workers.uneven_config(case, backend)
    split = {"dec": True, "enc": cfg.family == "encdec"}
    want = (_chip_smoke().lm_train_launches(cfg, model_axis=4, seq_split=tuple(split.values()))
            if backend == "pallas" else {})
    for rank, r in enumerate(sp4):
        s = r["steps"][(case, backend)]
        assert s["seq_split"] == split and s["launches"] == want
        _hold_step(s, rank, grad_tol=2e-5)


@pytest.mark.parametrize("case,backend", ATTN, ids=lambda v: str(v))
def test_whole_attention_runs_on_each_ranks_tokens(sp4, case, backend):
    # through K/V's gradient the quantized backend may move a code by an ulp of
    # its sum's order: those are held by the fed steps above
    exact_kv = backend != "pallas"
    names = None
    for r in sp4:
        c = r["attention"][(case, backend)]
        a, n = c["start"], c["n"]
        names = names or sorted(c["got"])
        assert sorted(c["got"]) == names and all(c["got"][k]["whole"] for k in names)
        for name in names:
            got, ref = c["got"][name], c["ref"][name]
            assert torch.equal(got["y"], ref["y"][:, a:a + n]), name
            if name.endswith("xattn"):  # the queries' data gradient alone
                assert torch.equal(got["dx"], ref["dx"][:, a:a + n]), name
            for what in ("dx", "dmem") if exact_kv else ():
                if got[what] is not None:
                    assert _rel(got[what], ref[what][:, a:a + n]) <= 1e-6, (name, what)
    for name in names:
        ref = sp4[0]["attention"][(case, backend)]["ref"][name]["grads"]
        for k, want in ref.items():
            if exact_kv or k.startswith(("wq.", "wo.")):
                summed = sum(r["attention"][(case, backend)]["got"][name]["grads"][k]
                             for r in sp4)
                assert _rel(summed, want) <= 1e-6, (name, k)


def test_lint_names_what_runs_on_each_ranks_tokens():
    seamless = configs.get_config("seamless-m4t-medium")
    res = lint_tensor_parallel(seamless, 16, seq_shard=True, seq_len=4096)
    assert res.ok
    assert any("whole attention runs wq, wk, wv and wo on each rank's own tokens" in w
               for w in res.warnings)
    assert any("whole vocabulary's head and loss run on each rank's own tokens" in w
               for w in res.warnings)
    assert not any("stays whole over" in w for w in res.warnings)
    glm = configs.get_config("chatglm3-6b")
    res = lint_tensor_parallel(glm, 16, seq_shard=True, seq_len=4096)
    assert any("replicated kv linears run on each rank's own tokens" in w for w in res.warnings)
    assert not any("own tokens" in w for w in lint_tensor_parallel(glm, 2, seq_shard=True,
                                                                    seq_len=4096).warnings)
    assert not any("own tokens" in w for w in lint_tensor_parallel(glm, 16).warnings)


@pytest.mark.parametrize("seq_len,why", [(4100, "16 does not divide it"),
                                         (1024, "64 positions are not whole scaling groups"),
                                         (1, "16 does not divide it")])
def test_lint_names_a_sequence_that_stays_whole(seq_len, why):
    cfg = dataclasses.replace(configs.get_config("seamless-m4t-medium"), quant_backend="pallas")
    assert seq_unit(cfg, 16) == cfg.qcfg().k_block == 128
    res = lint_tensor_parallel(cfg, 16, seq_shard=True, seq_len=seq_len)
    assert res.ok and any(f"a sequence of {seq_len} stays whole" in w and why in w
                          for w in res.warnings)


def test_dry_run_counts_the_sequence_collectives_with_the_ring_formulas():
    from torch._subclasses.fake_tensor import FakeTensorMode

    rows, seq, d, data, model = 2, 64, 32, 2, 4
    with dryrun.fake_world(data * model):
        mesh = make_mesh((data, model), ("data", "model"), "cpu")
        sp = SeqShard(TensorParallel(mesh.get_local_rank("model"), model,
                                     mesh.get_group("model")), seq)
        with FakeTensorMode():
            x = torch.zeros(rows, seq // model, d, requires_grad=True)
            counter = StepCounter(mesh_dims(mesh))
            with counter:
                scatter_seq(gather_seq(x, sp) * 2.0, sp).sum().backward()
    hlo = counter.hlo()
    whole = rows * seq * d * 4  # the gathered fp32 sequence
    gather = whole * (model - 1) / model  # all-gather: out (g-1)/g
    scatter = whole // model * (model - 1)  # reduce-scatter: out (g-1)
    want = {"all-gather": 2 * gather, "reduce-scatter": 2 * scatter}  # forward and backward
    assert {k: v for k, v in hlo["coll_breakdown"].items() if ":" not in k} == want
    assert hlo["coll_counts"] == {"all-gather": 2, "reduce-scatter": 2}
    assert hlo["coll_by_dim"] == {"model": 2 * gather + 2 * scatter}
