"""The port's planted-overlap control (K5) against the JAX package's.

The JAX K5 (``repro.analysis.kernel_verify._sabotage_overlap_jaxpr``) runs
here in Pallas interpret mode through ``jax.core.eval_jaxpr``; its
``BlockSpec`` index maps evaluate the same way.  The port's plain version
(``kernels.ref.sabotage_overlap_ref``) replays the TPU's sequential grid,
and its launch descriptor (``kernels.sabotage.launch_spec``) must give the
same write table, which the port's verifier reports as an overlap and a
gap.  Inputs are seeded numpy normals.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.analysis import kernel_verify as jkv  # noqa: E402
from repro_torch.analysis import kernel_verify as kv  # noqa: E402
from repro_torch.kernels import launch_counts, recorded_specs, reset_launch_counts  # noqa: E402
from repro_torch.kernels.ref import sabotage_overlap_ref, sabotage_overlap_tiles  # noqa: E402
from repro_torch.kernels.sabotage import launch_spec, sabotage_overlap_matmul  # noqa: E402


@pytest.fixture(scope="module")
def jax_k5():
    return jkv._sabotage_overlap_jaxpr()


def _pallas_eqn(jaxpr):
    """The one pallas_call of a jaxpr, searched through nested jaxprs."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            return eqn
        for v in eqn.params.values():
            sub = getattr(v, "jaxpr", v)
            if hasattr(sub, "eqns"):
                found = _pallas_eqn(sub)
                if found is not None:
                    return found
    return None


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((8, 16)).astype(np.float32),
            rng.standard_normal((16, 32)).astype(np.float32))


def _block_column(a, c):
    return a[:, 8 * c : 8 * c + 8]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_version_matches_jax_k5(jax_k5, seed):
    """Blocks 0 and 2 hold the last writer's tile (j = 1, j = 3) within
    2e-6: the TPU's dots and the port's ordered sums group the 16-term sums
    differently.  Blocks 1 and 3 are NaN in both."""
    x, w = _inputs(seed)
    want = np.asarray(jax.core.eval_jaxpr(jax_k5.jaxpr, jax_k5.consts, x, w)[0])
    got, writes = sabotage_overlap_ref(torch.from_numpy(x), torch.from_numpy(w))
    got, writes = got.numpy(), writes.numpy()
    for c in range(4):
        if c % 2:
            assert np.isnan(_block_column(want, c)).all()
            assert np.isnan(_block_column(got, c)).all()
            assert (_block_column(writes, c) == 0).all()
        else:
            np.testing.assert_allclose(_block_column(got, c), _block_column(want, c),
                                       rtol=0, atol=2e-6)
            np.testing.assert_allclose(_block_column(got, c), _block_column(x @ w, c + 1),
                                       rtol=0, atol=2e-6)
            assert (_block_column(writes, c) == 2).all()


def test_plain_version_keeps_the_last_writers_ordered_sum():
    x, w = (torch.from_numpy(a) for a in _inputs(3))
    tiles = sabotage_overlap_tiles(x, w)
    assert set(tiles) == {(0, j) for j in range(4)}
    out, _ = sabotage_overlap_ref(x, w)
    assert torch.equal(out[:, 0:8], tiles[(0, 1)])
    assert torch.equal(out[:, 16:24], tiles[(0, 3)])
    # the ordered sum: acc = p0 + p1, each p the in-order sum of 8 products
    p = [sum((x[:, k : k + 1] * w[k : k + 1, 8:16] for k in range(h, h + 8)),
             torch.zeros(8, 8)) for h in (0, 8)]
    assert torch.equal(tiles[(0, 1)], torch.zeros(8, 8) + p[0] + p[1])


def test_write_table_matches_the_jax_index_maps(jax_k5):
    """Grid (1, 4, 2); every operand's block at every grid point, the port's
    descriptor against the JAX BlockSpec index maps; the output lands on
    blocks (0, 0) and (0, 2) only."""
    gm = _pallas_eqn(jax_k5.jaxpr).params["grid_mapping"]
    spec = launch_spec(8, 16, 32)
    assert tuple(int(g) for g in gm.grid) == spec.shape == (1, 4, 2)
    assert len(gm.block_mappings) == len(spec.operands) == 3
    written = set()
    for bm, op in zip(gm.block_mappings, spec.operands):
        assert tuple(int(getattr(b, "block_size", b)) for b in bm.block_shape) == op.block
        im = bm.index_map_jaxpr
        for pt in np.ndindex(*spec.shape):
            want = tuple(int(v) for v in jax.core.eval_jaxpr(im.jaxpr, im.consts, *pt))
            assert tuple(int(v) for v in op.index_map(*pt)) == want, (op.name, pt)
            if op.output:
                written.add(want)
    assert written == {(0, 0), (0, 2)}


def test_verifier_reports_overlap_and_gap_at_the_output():
    rep = kv.verify_spec(launch_spec(8, 16, 32))
    kinds = {(v.kind, v.where) for v in rep.violations}
    assert kinds == {("overlap", "outputs[0]"), ("gap", "outputs[0]")}, rep.violations
    assert kv.writers_per_block(launch_spec(8, 16, 32), "outputs[0]").tolist() == [[2, 0, 2, 0]]
    assert rep.coverage["outputs[0]"]["index_map_grid_axes"] == ["tile_n"]
    assert rep.max_integer_bits == 0  # an fp32 kernel: nothing to budget


def test_wrapper_on_the_cpu_runs_the_plain_version_and_records_its_launch():
    x, w = (torch.from_numpy(a) for a in _inputs(4))
    probe = torch.zeros((8, 32), dtype=torch.int32)
    reset_launch_counts()
    out = sabotage_overlap_matmul(x, w, probe)
    want, writes = sabotage_overlap_ref(x, w)
    np.testing.assert_array_equal(out.numpy(), want.numpy())  # NaN == NaN here
    assert torch.equal(probe, writes)
    assert [int(_block_column(probe, c)[0, 0]) for c in range(4)] == [2, 0, 2, 0]
    assert launch_counts()["sabotage_overlap"] == 0  # no kernel on the CPU
    assert recorded_specs() == [(launch_spec(8, 16, 32), 1)]


@pytest.mark.parametrize("case", ["shape", "dtype", "probe"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    x, w = torch.zeros(8, 16), torch.zeros(16, 32)
    probe = None
    if case == "shape":
        x, w = torch.zeros(8, 12), torch.zeros(12, 32)
    elif case == "dtype":
        x = x.double()
    else:
        probe = torch.zeros((8, 32), dtype=torch.int64)
    with pytest.raises(ValueError):
        sabotage_overlap_matmul(x, w, probe)
