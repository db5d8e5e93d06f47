"""The MLS-compressed cross-pod gradient ring (``repro_torch.parallel.
compress``) and its wire audit against the JAX package.

- ``compress`` (K1's plain version here, grouping "nc" on rows of 128) and
  ``decompress`` equal JAX's ``compress``/``decompress`` bit for bit at
  nearest rounding, on a gradient with a ragged tail.  With rounding bytes
  they equal JAX's ``kernels.ref.quantize_ref`` fed the same bytes on the
  padded rows (JAX's ``compress`` draws its own from a key).
- JAX's own bounds (``tests/test_compress.py``): round-trip error < 0.05,
  the payload < 0.3 of fp32's, and stochastic rounding unbiased within
  5e-6.
- The ring in 2 and 4 gloo processes equals, bit for bit, the ordered sum
  computed here from JAX's ``decompress`` of each rank's payload: a rank's
  own fp32 gradient, then ranks i-1, i-2, ..., then / p.  Each rank sends
  exactly the ideal bytes.
- ``audit_wire_ring`` reports ratio >= 3.5 and exactly the ideal bytes,
  and the audit's gate holds the ratio.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as workers  # noqa: E402
from repro.core import FMT_IMAGENET as JFMT  # noqa: E402
from repro.kernels.ref import quantize_ref as jquantize_ref  # noqa: E402
from repro.parallel import compress as jcompress  # noqa: E402
from repro_torch.core import FMT_IMAGENET  # noqa: E402
from repro_torch.parallel import compress  # noqa: E402

torch.set_num_threads(1)
_jax_compress = jax.jit(jcompress.compress, static_argnums=(1, 2))
_jax_decompress = jax.jit(jcompress.decompress, static_argnums=(3, 4))
_jax_qref = jax.jit(jquantize_ref, static_argnums=(1, 2, 3, 5))
NUMEL = 37 * 53  # 1961: 15 full rows of 128 and a tail of 41


def _grad(seed=0, shape=(37, 53)):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * rng.uniform(1e-4, 1e-2, shape[:1] + (1,))
            ).astype(np.float32)


def test_compress_and_decompress_match_jax_at_nearest():
    g = _grad()
    codes, s_g, s_t = compress.compress(torch.from_numpy(g))
    jc, jsg, jst = _jax_compress(jnp.asarray(g), JFMT, 128)
    assert codes.shape == (16, 128) and s_g.shape == (16, 1)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s_g.numpy(), np.asarray(jsg))
    assert s_t.item() == float(jst)
    out = compress.decompress(codes, s_g, s_t, g.shape)
    np.testing.assert_array_equal(out.numpy(), np.asarray(_jax_decompress(jc, jsg, jst, g.shape,
                                                                           JFMT)))


def test_compress_with_rounding_bytes_matches_quantize_ref():
    g = _grad(1)
    r = np.random.default_rng(2).integers(0, 256, (16, 128), dtype=np.uint8)
    codes, s_g, s_t = compress.compress(torch.from_numpy(g), r_u8=torch.from_numpy(r))
    rows = np.concatenate([g.reshape(-1), np.zeros(16 * 128 - NUMEL, np.float32)])
    jc, jsg, jst = _jax_qref(jnp.asarray(rows.reshape(16, 128)), JFMT, 128,
                             jcompress.GS_FMT_DEFAULT, jnp.asarray(r), "nc")
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s_g.numpy(), np.asarray(jsg))
    assert s_t.item() == float(jst)


def test_codec_bounds_of_the_jax_tests():
    g = torch.from_numpy((np.random.default_rng(0).standard_normal(1000) * 1e-3)
                         .astype(np.float32))
    codes, sg, st = compress.compress(g)
    r = compress.decompress(codes, sg, st, g.shape)
    assert float((r - g).abs().mean() / g.abs().mean()) < 0.05
    assert codes.numel() + sg.numel() * 4 + 4 < 0.3 * g.numel() * 4
    g = torch.cat([torch.full((20000,), 3.33e-4), torch.tensor([1e-3])])
    rows = -(-g.numel() // 128)
    r_u8 = torch.randint(0, 256, (rows, 128), generator=torch.Generator().manual_seed(1),
                         dtype=torch.uint8)
    r = compress.decompress(*compress.compress(g, FMT_IMAGENET, 128, r_u8), g.shape)
    assert abs(float(r[:-1].mean()) - 3.33e-4) < 5e-6


@pytest.fixture(scope="module")
def rings():
    return {p: workers.run_world(workers.ring_worker, p, NUMEL, 5) for p in (2, 4)}


@pytest.mark.parametrize("p", [2, 4])
def test_ring_is_the_ordered_sum_bit_for_bit(rings, p):
    payloads = []
    for i in range(p):
        grad, r_u8 = workers.ring_inputs(i, NUMEL, 5)
        payloads.append((grad, [jnp.asarray(t.numpy()) for t in
                                compress.compress(grad, r_u8=r_u8)]))
    rows = -(-NUMEL // 128)  # per hop: the padded rows' codes, their scales and s_t
    for i, res in enumerate(rings[p]):
        acc = jnp.asarray(payloads[i][0].numpy())
        for h in range(1, p):
            acc = acc + _jax_decompress(*payloads[(i - h) % p][1], (NUMEL,), JFMT)
        np.testing.assert_array_equal(res["out"].numpy(), np.asarray(acc / p))
        assert res["wire"] == {"u8": rows * 128 * (p - 1), "f32": (rows * 4 + 4) * (p - 1),
                               "sends": 3 * (p - 1)}


def test_audit_wire_ring_and_gate():
    from repro_torch.analysis import audit
    from repro_torch.analysis.wire import audit_wire_ring

    w = audit_wire_ring()
    assert w["wire_bytes_per_device"] == w["ideal_compressed_bytes_per_device"] == 67588.0
    assert w["wire_bytes_by_dtype"] == {"f32": 2052.0, "u8": 65536.0}
    assert w["fp32_ring_bytes_per_device"] == 262144.0 and w["n_collective_permutes"] == 3
    assert w["compression_ratio"] >= 3.5
    base = {"min_wire_compression_ratio": 3.5}
    assert audit.apply_gate({"graphs": {}, "wire_ring": w}, base) == []
    assert audit.apply_gate({"graphs": {}, "wire_ring": dict(w, compression_ratio=1.0)},
                            base) == ["wire ring: compression ratio 1.00 < 3.5"]
