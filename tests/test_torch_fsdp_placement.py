"""The launcher's FSDP2 placement (``launch.train.fsdp_shard_dim``, used by
``shard_model``): a parameter shards on dim 0 where the data axis divides
dim 0 or dim 0 is at least the data axis; else on the JAX package's
``fsdp`` dim where the data axis divides it; else on dim 0, padded.

- **The rule** on shapes: a rank's stack of fewer experts than data ranks
  takes its ``d_model`` dim (1 of ``w_gate``/``w_up``, 2 of ``w_down``); a
  whole vocabulary the axis does not divide keeps dim 0.
- **A gloo world of 4** (data 2 x model 2, ``torch_dist_workers.
  placement_worker``): llama4-scout's smoke config widened for the model
  axis, fp32, with 2 experts, one a rank.  Each stack is ``Shard(d)``,
  ``d`` JAX's ``fsdp`` dim, and its local shard half the rank's stack;
  every other parameter takes the rule's placement.  The loss and
  gradients on each rank's slice equal one process running the two data
  slices as microbatches (not the whole batch: an expert's capacity
  follows the tokens of a call) to the HSDP test's tolerances (``tests/test_torch_launch.py``: 1e-6 on the
  loss, 1e-5 of the largest gradient), and one launcher step equals one
  process's microbatch-2 step within 1e-6.
- **Against JAX** at the production meshes (16 x 16 and 2 x 16 x 16):
  every expert stack's rank-0 shard (``tp_layout`` at model 16, then the
  rule at data 16) has the per-device shape of the JAX package's layout
  (its ``repro.parallel.specs`` PartitionSpecs over the mesh's axis
  sizes); and in all ten archs, every parameter to which JAX's rules give
  an ``fsdp`` axis has a rank-0 chunk that is an even split of the rank's
  tensor-parallel part, or, where dim 0 is at least the data axis, at most
  one dim-0 row beyond it.  Other parameters are not held to JAX's bytes:
  the port's tensor-parallel splits in whole groups give rank 0 more than
  JAX's even split by design.
"""
import dataclasses
import math
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jlspecs  # noqa: E402
from repro.parallel import specs as jspecs  # noqa: E402
from repro.parallel.sharding import DEFAULT_RULES as JAX_RULES  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import RunConfig  # noqa: E402
from repro_torch.launch.specs import abstract_params  # noqa: E402
from repro_torch.launch.train import fsdp_shard_dim  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.parallel.tensor import tp_layout  # noqa: E402
from repro_torch.train import make_train_step  # noqa: E402

MOE_ARCHS = ("llama4-scout-17b-a16e", "moonshot-v1-16b-a3b")
STACKS = {"moe.w_gate": 1, "moe.w_up": 1, "moe.w_down": 2}  # JAX's fsdp dim of each
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_rule_takes_jax_fsdp_dim_only_where_dim_0_would_pad():
    assert fsdp_shard_dim("layers.0.moe.w_gate", (1, 5120, 8192), 16) == 1
    assert fsdp_shard_dim("layers.0.moe.w_up", (4, 2048, 1408), 16) == 1
    assert fsdp_shard_dim("layers.0.moe.w_down", (1, 8192, 5120), 16) == 2
    assert fsdp_shard_dim("layers.0.moe.w_gate", (32, 2048, 1408), 16) == 0  # divides
    assert fsdp_shard_dim("emb", (50280, 1024), 16) == 0  # at least the axis: pads one row
    assert fsdp_shard_dim("layers.0.moe.w_gate", (1, 100, 8), 16) == 0  # fsdp dim: no
    assert fsdp_shard_dim("layers.0.ln1.gamma", (3,), 16) == 0  # no fsdp axis
    assert fsdp_shard_dim("layers.0.moe.w_gate", (1, 64, 64), 1) == 0  # no data axis


# ---------------------------------------------------------------------------
# a gloo world of 4: data 2 x model 2
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def placed():
    return workers.run_world(workers.placement_worker, 4)


def _take(r, k, t):
    """Rank ``r``'s tensor-parallel part of the unsharded ``t``."""
    return r["layout"][k].take(t, r["coord"][2]) if k in r["layout"] else t


def test_expert_stacks_shard_on_jax_fsdp_dim_with_half_the_bytes(placed):
    from torch.distributed.tensor import Replicate, Shard

    cfg = workers.placement_config()
    for r in placed:
        stacks = [k for k in r["shapes"] if k.split(".", 2)[-1] in STACKS]
        assert len(stacks) == 3 * sum(".moe.w_gate" in k for k in r["shapes"]) > 0
        for k in stacks:
            d = STACKS[k.split(".", 2)[-1]]
            shape, local = r["shapes"][k], r["local"][k]
            assert shape[0] == cfg.n_experts // 2 == 1  # one expert a rank
            assert r["placements"][k] == (Replicate(), Shard(d)), k
            assert local[d] * 2 == shape[d] and math.prod(local) * 2 == math.prod(shape), k
        for k, shape in r["shapes"].items():
            assert r["placements"][k] == (Replicate(), Shard(fsdp_shard_dim(k, shape, 2))), k


def _reference(n_parts):
    """One process: the losses of the global batch's ``n_parts`` slices as
    microbatches and the gradients of their mean."""
    cfg = workers.placement_config()
    model = lm.init_lm(cfg, seed=0, device="cpu")
    losses = []
    for part in workers.tp_batch(cfg)["tokens"].chunk(n_parts):
        loss, _ = model.loss({"tokens": part}, workers.TP_KEY)
        (loss / n_parts).backward()
        losses.append(loss.detach())
    return losses, {k: p.grad for k, p in model.named_parameters()}


def test_loss_and_gradients_match_one_process(placed):
    losses, grads = _reference(2)
    for r in placed:  # each data rank's slice, both model ranks alike
        assert abs(r["loss"].item() - losses[r["coord"][1]].item()) <= 1e-6
        assert r["grads"].keys() == grads.keys()
        for k, g in grads.items():
            want = _take(r, k, g)
            tol = 1e-5 * want.abs().max().item() + 1e-12
            assert (r["grads"][k] - want).abs().max().item() <= tol, k


def test_launcher_step_matches_one_process_microbatch_step(placed):
    cfg = workers.placement_config()
    shape = dataclasses.replace(configs.SHAPES["train_4k"], global_batch=workers.TP_BATCH,
                                seq_len=workers.TP_SEQ)
    step, init = make_train_step(RunConfig(model=cfg, shape=shape, microbatch=2))
    model = lm.init_lm(cfg, seed=0, device="cpu")
    model, _, m = step(model, init(model), workers.tp_batch(cfg))
    for r in placed:
        got = r["step"]
        assert got["world"] == 4 and abs(got["losses"][0] - m["loss"].item()) <= 1e-6
        for k, p in model.named_parameters():
            assert (got["params"][k] - _take(r, k, p.detach())).abs().max().item() <= 1e-6, k


# ---------------------------------------------------------------------------
# against the JAX package's layout at the production meshes
# ---------------------------------------------------------------------------
def _jax_leaves(arch):
    """``{JAX pytree path: shape}`` of the JAX package's parameters of ``arch``."""
    tree = jlspecs.abstract_params(jconfigs.get_config(arch))
    return {jax.tree_util.keystr(p): tuple(v.shape)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_path(name: str) -> tuple[str, bool]:
    """The JAX pytree path of port parameter ``name`` and whether its leaf
    is a stack of layers."""
    keys = name.split(".")
    stacked = keys[0] in ("layers", "enc_layers") and keys[1].isdigit()
    if stacked:
        del keys[1]
    return "".join(f"['{k}']" for k in keys), stacked


def _per_device(spec, shape, sizes) -> tuple[int, ...]:
    """A leaf's shape on one device of JAX's layout."""
    out = []
    for dim, e in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        names = () if e is None else (e,) if isinstance(e, str) else e
        out.append(dim // math.prod(sizes[a] for a in names))
    return tuple(out)


def _rank0(arch, mesh_name):
    """Per port parameter: (rank 0's tensor-parallel shape at model 16, the
    rule's dim at data 16, rank 0's FSDP2 chunk shape, JAX's spec and its
    per-device shape of the same layer)."""
    names, shape = MESHES[mesh_name]
    sizes = dict(zip(names, shape))
    ref = types.SimpleNamespace(axis_names=names, devices=np.empty(shape))
    cfg = configs.get_config(arch)
    shapes = {k: tuple(t.shape) for k, t in abstract_params(cfg).items()}
    layout = tp_layout(cfg, shapes, sizes["model"])
    jleaves = _jax_leaves(arch)
    out = {}
    for k, s in shapes.items():
        local = list(s)
        if k in layout:
            local[layout[k].dim] = layout[k].size(0)
        d = fsdp_shard_dim(k, tuple(local), sizes["data"])
        chunk = list(local)
        chunk[d] = -(-local[d] // sizes["data"])
        jpath, stacked = _jax_path(k)
        jshape = jleaves[jpath]
        spec = tuple(jspecs.spec_for(jpath, jshape, ref, JAX_RULES))
        dev = _per_device(spec, jshape, sizes)
        if stacked:
            spec, dev = spec[1:], dev[1:]
        out[k] = (tuple(local), d, tuple(chunk), spec, dev)
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_stack_shards_equal_jax_per_device_shapes(arch, mesh_name):
    got = _rank0(arch, mesh_name)
    stacks = {k: v for k, v in got.items() if k.split(".", 2)[-1] in STACKS}
    assert stacks
    for k, (local, d, chunk, _, dev) in stacks.items():
        assert d == STACKS[k.split(".", 2)[-1]], k
        assert chunk == dev, (k, chunk, dev)
    want = {"llama4-scout-17b-a16e": (1, 320, 8192), "moonshot-v1-16b-a3b": (4, 128, 1408)}
    first = next(k for k in stacks if k.endswith("moe.w_gate"))
    assert stacks[first][2] == want[arch]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(configs.ARCHS))
def test_no_fsdp_parameter_pads_beyond_one_dim_0_row(arch, mesh_name):
    got = _rank0(arch, mesh_name)
    data = dict(zip(*MESHES[mesh_name]))["data"]
    held = 0
    for k, (local, d, chunk, spec, _) in got.items():
        if not any(e == "data" or (isinstance(e, tuple) and "data" in e) for e in spec):
            continue  # JAX gives it no fsdp axis
        held += 1
        n, row = math.prod(local), math.prod(local[1:])
        if math.prod(chunk) * data != n:  # padded: only a dim 0 of at least the axis
            assert d == 0 and local[0] >= data and math.prod(chunk) * data <= n + data * row, (
                k, local, chunk)
    assert held > 0
