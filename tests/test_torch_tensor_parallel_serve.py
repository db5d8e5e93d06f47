"""Serving a tensor-parallel model (``models/lm.py`` prefill and decode,
``serve.ServeEngine``) on worlds of gloo processes on the CPU, against the
unsharded port and the JAX package's unsharded ``lm.prefill`` /
``lm.decode_step``.

Each family's smoke config widened as the launcher widens it under a
model axis (``torch_dist_workers.serve_config``: chatglm3-6b,
moonshot-v1-16b-a3b, llama4-scout-17b-a16e, mamba2-370m, zamba2-7b,
seamless-m4t-medium), fp32, unquantized, on the fake-quant backend and on
the quantized one (K1/K3's plain versions), nearest rounding: a prefill of
2 prompts of 8 tokens (the encoder-decoder's over 12 source frames) and 4
decode steps teacher-forced on seeded tokens.

- World 2, model 2, each arch and backend: every step's logits, whole on
  every rank (equal bit for bit across the ranks), within 1e-5 relative
  (L2) of the unsharded port's; quantized, each linear (and MoE layer) of
  the tensor-parallel run fed the unsharded run's input
  (``torch_dist_workers._linear_feed``), since a row-parallel sum's order
  can move a code.  Layer 0's cache after the prefill (K/V, the cross
  K/V, the Mamba2 conv and SSM states, the hybrid's first ring buffer) is
  the rank's slice of the unsharded cache bit for bit, in the shapes
  ``lm.cache_spec(..., tp=...)`` gives; but for the hybrid's ring buffer
  and the cross K/V unquantized, and so unfed: they are computed from the
  output of a segment of Mamba2 layers or of the encoder, whose
  row-parallel sums differ from the unsharded ones in their order, so
  they are held within 1e-6 relative (L2; seen: 9.1e-8).  The quantized run's K1 and K3
  launches of a decode step equal ``chip_smoke.serve_launches(cfg,
  model_axis=2)``.  ``ServeEngine.generate`` gives the same greedy tokens
  on every rank, and the unsharded engine's.  ``LM.forward``'s logits are
  whole and within 1e-5 of the unsharded forward's.
- The unquantized tensor-parallel run on the JAX package's parameters
  against JAX's unsharded prefill and decode: within 1e-4 (dense, moe,
  ssm, hybrid, encdec).
- World 4: chatglm3-6b at model 4 (its 2 kv heads replicated: a rank's
  cache holds the one its query heads read), each backend as above; and
  the dense model served through ``launch.train.shard_model`` at data 2 x
  model 2 (FSDP2 over data, prefill and decode as registered forwards),
  each data rank on its half of the prompts: the unsharded prefill's
  logits of those rows within 1e-5, the same tokens on both model ranks.
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
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.tensor import TensorParallel, mamba_heads  # noqa: E402

ARCHS = workers.SERVE_ARCHS
BACKENDS = workers.TP_BACKENDS
CASES = [(a, b) for a in ARCHS for b in BACKENDS]
JAX_ARCHS = ("chatglm3-6b", "moonshot-v1-16b-a3b", "mamba2-370m", "zamba2-7b",
             "seamless-m4t-medium")
# the fields the launcher widens under a model axis (launch.train.tp_smoke)
WIDENED = ("head_dim", "n_kv_heads", "d_ff", "d_model", "ssm_headdim", "moe_d_ff")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ref():
    """Per arch: JAX's unquantized prefill and decode logits on the workers'
    inputs, and its parameters as the port's state dict."""
    out = {}
    for arch in JAX_ARCHS:
        cfg = workers.serve_config(arch, "off")
        over = {k: getattr(cfg, k) for k in WIDENED}
        jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **over, quant=False)
        params = jlm.init_lm(jax.random.key(0), jcfg)
        batch, steps = workers.serve_inputs(cfg)
        batch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
        prefill = jax.jit(lambda p, b: jlm.prefill(p, b, jcfg, workers.SERVE_MAX))
        decode = jax.jit(lambda p, c, t: jlm.decode_step(p, c, t, jcfg))
        logits, cache = prefill(params, batch)
        got = [np.asarray(logits)]
        for i in range(workers.SERVE_STEPS):
            logits, cache = decode(params, cache, jnp.asarray(steps[:, i:i + 1].numpy()))
            got.append(np.asarray(logits))
        out[arch] = dict(state=lm_params_from_jax(jax.tree.map(np.asarray, params), cfg),
                         logits=np.stack(got))
    return out


@pytest.fixture(scope="module")
def tp2(jax_ref):
    return workers.run_world(workers.serve_tp2_worker, 2,
                             {a: r["state"] for a, r in jax_ref.items()})


@pytest.fixture(scope="module")
def tp4():
    return workers.run_world(workers.serve_tp4_worker, 4)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def _hold_case(ranks, tol=1e-5):
    for c in ranks:
        assert c["logits"].shape == c["ref_logits"].shape
        assert c["logits"].shape[-1] == c["ref_logits"].shape[-1]
        assert _rel(c["logits"], c["ref_logits"]) <= tol
    assert all(torch.equal(c["logits"], ranks[0]["logits"]) for c in ranks)


@pytest.mark.parametrize("arch,backend", CASES)
def test_serving_matches_the_unsharded_port_at_model_2(tp2, arch, backend):
    _hold_case([r["cases"][(arch, backend)] for r in tp2])


@pytest.mark.parametrize("arch,backend", CASES)
def test_layer_0_cache_is_the_rank_slice_of_the_unsharded(tp2, arch, backend):
    for r in tp2:
        c = r["cases"][(arch, backend)]
        assert c["cache_exact"]
        for name, exact in c["cache_exact"].items():
            if name in ("ak", "av", "xk", "xv") and backend == "off":  # after row sums
                assert c["cache_rel"][name] <= 1e-6, (name, c["cache_rel"])
            else:
                assert exact, (name, c["cache_rel"])
        for name, (got, spec) in c["cache_shapes"].items():
            assert got == spec, name


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_launches_per_rank_equal_the_closed_form(tp2, arch):
    cfg = workers.serve_config(arch, "pallas")
    cs = _chip_smoke()
    want = cs.serve_launches(cfg, model_axis=2)
    for r in tp2:
        assert r["cases"][(arch, "pallas")]["decode_launches"] == want
        assert r["cases"][(arch, "pallas")]["ref_launches"] == cs.serve_launches(cfg)
        assert r["cases"][(arch, "fake_quant")]["decode_launches"] == {}


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_are_the_same_on_every_rank_and_unsharded(tp2, arch):
    toks = [r["cases"][(arch, "off")]["tokens"] for r in tp2]
    assert toks[0].shape == (workers.SERVE_BATCH, 6)
    assert all(torch.equal(t, toks[0]) for t in toks)
    assert torch.equal(toks[0], tp2[0]["cases"][(arch, "off")]["ref_tokens"])


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_are_whole_on_every_rank(tp2, arch):
    cfg = workers.serve_config(arch, "off")
    for r in tp2:
        got, want = r["forward"][arch]
        assert got.shape == (workers.SERVE_BATCH, workers.SERVE_PROMPT, cfg.vocab)
        assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize("arch", JAX_ARCHS)
def test_tp_serving_matches_jax_unsharded_prefill_and_decode(tp2, jax_ref, arch):
    for r in tp2:
        got = r["jax"][arch]
        assert got.shape == jax_ref[arch]["logits"].shape
        assert _rel(got, jax_ref[arch]["logits"]) <= 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_model_4_serves_from_the_replicated_kv_head_its_queries_read(tp4, backend):
    ranks = [r["cases"][backend] for r in tp4]
    _hold_case(ranks)
    for c in ranks:
        assert all(c["cache_exact"].values()), c["cache_exact"]
        assert c["cache_shapes"]["k"][0][2] == 1  # one of the 2 kv heads a rank
    if backend == "pallas":
        want = _chip_smoke().serve_launches(workers.serve_config("chatglm3-6b", "pallas"),
                                            model_axis=4)
        assert all(c["decode_launches"] == want for c in ranks)


def test_serving_through_shard_model_at_data_2_model_2(tp4):
    cfg = workers.serve_config("chatglm3-6b", "off")
    batch, _ = workers.serve_inputs(cfg)
    want, _ = lm.prefill(lm.init_lm(cfg, seed=0, device="cpu"), batch, workers.SERVE_MAX)
    half = workers.SERVE_BATCH // 2
    for r in tp4:
        data, model = r["hsdp"]["coord"]
        assert _rel(r["hsdp"]["logits"], want[data * half:(data + 1) * half]) <= 1e-5
        twin = tp4[data * 2 + (1 - model)]["hsdp"]  # the other rank of its model group
        assert torch.equal(r["hsdp"]["tokens"], twin["tokens"])


@pytest.mark.parametrize("arch,model_axis", [("chatglm3-6b", 2), ("chatglm3-6b", 4),
                                             ("zamba2-7b", 2), ("mamba2-370m", 4)])
def test_cache_spec_gives_each_rank_its_part(arch, model_axis):
    cfg = configs.get_config(arch)
    shapes = [lm.cache_spec(cfg, 8, 1024, tp=TensorParallel(r, model_axis))
              for r in range(model_axis)]
    whole = lm.cache_spec(cfg, 8, 1024)
    assert set(shapes[0]) == set(whole)
    if cfg.family in ("ssm", "hybrid"):
        heads = mamba_heads(cfg, model_axis)
        conv = [s["conv"][0][-1] for s in shapes]
        bc = 2 * cfg.ssm_state
        # each rank its heads' x channels; the tail's B, C channels on rank 0
        assert conv == [(h1 - h0) * cfg.ssm_headdim + (bc if r == 0 else 0)
                        for r, (h0, h1) in enumerate(heads)]
        assert sum(conv) == whole["conv"][0][-1]
        assert sum(s["ssm"][0][2] for s in shapes) == cfg.ssm_heads
    if cfg.n_heads:
        key = "ak" if cfg.family == "hybrid" else "k"
        kv = [s[key][0][3] for s in shapes]
        want = cfg.n_kv_heads // model_axis if cfg.n_kv_heads % model_axis == 0 else 1
        assert kv == [want] * model_axis
    assert {k: v[0] for k, v in lm.cache_spec(cfg, 8, 1024, tp=TensorParallel(0, 1)).items()} \
        == {k: v[0] for k, v in whole.items()}
    assert abstract_params(cfg)  # the config builds on the meta device
