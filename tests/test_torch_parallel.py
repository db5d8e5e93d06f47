"""The port's logical-axis sharding and layouts (``repro_torch.parallel.
sharding`` / ``.specs``) against the JAX package's.

JAX's ``logical_to_mesh``, ``_prune``, ``shard``, ``spec_for`` and
``_named`` read only ``mesh.axis_names`` and ``mesh.devices.shape``, so a
stand-in object with a (16, 16) or (2, 16, 16) numpy array carries JAX's
production meshes without 512 devices; the port reads the same mesh as a
``MeshShape``.  JAX's ``with_sharding_constraint`` / ``NamedSharding`` are
replaced by the identity on the spec so its ``shard`` and ``batch_/
cache_shardings`` return their specs.

- ``logical_to_mesh`` / ``_prune`` equal JAX's for both rule sets.
- ``shard_spec`` (what ``shard`` gives a DTensor) equals the spec of
  JAX's ``shard`` under its dropping rules.
- ``spec_for`` on every parameter of every full arch: JAX's
  ``eval_shape(init_lm)`` tree against the port's meta-device parameters
  (``launch.specs.abstract_params``), name for name through
  ``convert.lm_params_from_jax``'s mapping, JAX's leading ``stage`` axis of
  a stacked leaf dropped.
- ``batch_shardings`` / ``cache_shardings`` equal JAX's.
- On a gloo ("pod", "data") mesh of 4 CPU processes: ``shard`` and
  ``wire_pin`` redistribute DTensors as their specs say, are the identity
  on plain tensors and without rules, and ``placements`` maps specs to
  ``Shard``/``Replicate``.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import specs as jlspecs  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro.parallel import specs as jspecs  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import specs as lspecs  # noqa: E402
from repro_torch.parallel import sharding, specs  # noqa: E402
from repro_torch.parallel.sharding import MeshShape  # noqa: E402

MESHES = [(("data", "model"), (16, 16)), (("pod", "data", "model"), (2, 16, 16)),
          (("data",), (4,)), (("pod", "data"), (2, 2))]
MESH_IDS = ["16x16", "2x16x16", "data4", "pod2xdata2"]
RULES = {"default": (sharding.DEFAULT_RULES, jsharding.DEFAULT_RULES),
         "sp": (sharding.SP_RULES, jsharding.SP_RULES)}
LOGICAL = [("batch", None), ("batch", "seq", "embed"), ("batch", "seq", "heads", None),
           ("stage", "fsdp", "mlp"), ("vocab", "fsdp"), ("expert", "fsdp", None),
           ("moe_rows", None, "embed"), ("cache_seq", "kv_heads"), (None, None), ()]


def _meshes(i):
    names, shape = MESHES[i]
    return MeshShape(names, shape), types.SimpleNamespace(axis_names=names,
                                                          devices=np.empty(shape))


def _t(spec) -> tuple:
    return tuple(spec)


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("m", range(len(MESHES)), ids=MESH_IDS)
def test_logical_to_mesh_and_prune_match_jax(m, rules):
    ours, ref = _meshes(m)
    r, jr = RULES[rules]
    assert r == sharding.AxisRules(jr.rules)
    for logical in LOGICAL:
        assert _t(sharding.logical_to_mesh(logical, r, ours)) == \
            _t(jsharding.logical_to_mesh(logical, jr, ref)), logical
        assert _t(sharding.logical_to_mesh(logical, r)) == _t(jsharding.logical_to_mesh(logical,
                                                                                           jr))
        for name in filter(None, logical):
            assert sharding._prune(ours, r.get(name)) == jsharding._prune(ref, jr.get(name))


SHAPES = [(8, 64), (1, 64), (8, 4096, 64), (8, 4096, 32, 128), (4, 1024, 8), (3, 7, 5),
          (2, 2, 2), (64, 16, 4)]


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("m", range(len(MESHES)), ids=MESH_IDS)
def test_shard_spec_matches_jax_dropping_rules(m, rules, monkeypatch):
    ours, ref = _meshes(m)
    r, jr = RULES[rules]
    monkeypatch.setattr(jax.lax, "with_sharding_constraint", lambda x, spec: spec)
    n = 0
    with jsharding.axis_rules(jr, ref):
        for logical in LOGICAL:
            for shape in SHAPES:
                if len(shape) != len(logical):
                    continue
                x = types.SimpleNamespace(shape=shape, ndim=len(shape))
                assert _t(sharding.shard_spec(shape, logical, r, ours)) == \
                    _t(jsharding.shard(x, *logical)), (logical, shape)
                n += 1
    assert n > 10


def _jax_leaves(tree) -> dict[str, tuple[tuple, str]]:
    return {jax.tree_util.keystr(p): (tuple(v.shape), str(v.dtype))
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_name(jpath: str, i: int | None) -> str:
    keys = jpath[2:-2].split("']['")
    if i is not None:
        keys.insert(1, str(i))
    return ".".join(keys)


@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_spec_for_every_parameter_of_every_full_arch_matches_jax(name):
    jcfg, cfg = jconfigs.get_config(name), configs.get_config(name)
    jtree = _jax_leaves(jlspecs.abstract_params(jcfg))
    ours = lspecs.abstract_params(cfg)
    assert all(t.device.type == "meta" for t in ours.values())
    stacks = {"layers": cfg.n_layers, "enc_layers": cfg.enc_layers}
    seen = set()
    for jpath, (shape, dtype) in jtree.items():
        stack = jpath[2:].split("'")[0]
        n = stacks.get(stack)
        for i in ((0, n - 1) if n else (None,)):
            pname = _port_name(jpath, i)
            t = ours[pname]
            want = shape[1:] if n else shape
            assert tuple(t.shape) == want and str(t.dtype) == "torch." + dtype, pname
            seen.add(pname)
            for m in range(2):
                mesh, ref = _meshes(m)
                for r, jr in RULES.values():
                    jspec = _t(jspecs.spec_for(jpath, shape, ref, jr))
                    assert _t(specs.spec_for(pname, t.shape, mesh, r)) == \
                        (jspec[1:] if n else jspec), (pname, jspec)
    per_layer = {k for k in ours if not k.startswith(("layers.", "enc_layers."))}
    assert per_layer <= seen
    assert len(ours) == sum(stacks.get(p[2:].split("'")[0]) or 1 for p in jtree)
    mesh, _ = _meshes(1)
    got = specs.param_shardings(ours, mesh)
    assert got.keys() == ours.keys()
    assert all(got[k] == specs.spec_for(k, ours[k].shape, mesh) for k in list(ours)[:50])


def _jax_named(monkeypatch):
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("m", range(3), ids=MESH_IDS[:3])
def test_batch_and_cache_shardings_match_jax(m, monkeypatch):
    _jax_named(monkeypatch)
    ours, ref = _meshes(m)
    for name in sorted(configs.ARCHS):
        cfg, jcfg = configs.get_config(name), jconfigs.get_config(name)
        for shape in configs.runnable_shapes(cfg):
            jshape = jconfigs.SHAPES[shape.name]
            for r, jr in RULES.values():
                got = specs.batch_shardings(lspecs.batch_specs(cfg, shape), ours, r)
                want = jspecs.batch_shardings(jlspecs.batch_specs(jcfg, jshape), ref, jr)
                assert {k: _t(v) for k, v in got.items()} == {k: _t(v) for k, v in want.items()}
                if shape.kind != "decode":
                    continue
                got = specs.cache_shardings(lspecs.cache_specs(cfg, shape), ours, r)
                want = jspecs.cache_shardings(jlspecs.cache_specs(jcfg, jshape), ref, jr)
                assert {k: _t(v) for k, v in got.items()} == {k: _t(v) for k, v in want.items()}


def test_placements_refuse_what_dtensor_cannot_express():
    mesh = MeshShape(("pod", "data", "model"), (2, 2, 2))
    assert [type(p).__name__ for p in sharding.placements(
        sharding.PartitionSpec(("pod", "data"), "model"), mesh)] == ["Shard", "Shard", "Shard"]
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements(sharding.PartitionSpec(("data", "pod")), mesh)
    with pytest.raises(ValueError, match="shards dims"):
        sharding.placements(sharding.PartitionSpec("data", "data"), mesh)


@pytest.fixture(scope="module")
def gloo_mesh():
    return workers.run_world(workers.placements_worker, 4)


def test_shard_and_wire_pin_on_a_gloo_mesh(gloo_mesh):
    from torch.distributed.tensor import Replicate, Shard

    x = torch.arange(8 * 6, dtype=torch.float32).reshape(8, 6)
    for res in gloo_mesh:
        pod, data = res["coord"]
        placements, local = res["batch"]
        assert placements == (Shard(0), Shard(0))  # batch -> ("pod", "data")
        assert torch.equal(local, x.chunk(4)[pod * 2 + data])
        assert res["plain_is_identity"] and res["wire_pin_plain"] and res["no_rules"]
        assert res["wire_pin"] == ((Replicate(), Replicate()), True)  # fsdp gathered on dim 0
        assert res["wire_pin_sp"] == (Replicate(), Replicate())  # seq-sharded: gather all
        assert res["param"] == (Replicate(), Shard(1))  # wo: (heads, fsdp) on pod x data
        assert res["batch_spec"] == (Shard(0), Shard(0))
