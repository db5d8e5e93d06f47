"""The fake-quant matmul's scaling groups at full width against the JAX
package: ``ModelConfig.qcfg()`` sets ``shard_ways=16`` in both packages,
and ``QuantConfig._aligned_kb`` narrows a group from 128 to 64, 32 or 16
where K / 128 is not a multiple of 16 (mamba2-370m's K = 1024 gets 64,
zamba2-7b's K = 3584 gets 32).  That changes the numbers on one device.

- For every full arch, every quantized GEMM's contraction width (each
  ``Linear``'s d_in and the MoE expert stacks' K, read from the model
  built on the meta device) gets JAX's group specs.
- ``lowbit_matmul`` and ``lowbit_matmul_stack`` at K = 256 with
  ``shard_ways=16`` (JAX's group: 16) match JAX's, forward and both
  gradients, with nearest rounding, to ``1e-5 * max|ref|`` absolute (the
  fake-quant cross-tests' tolerance: the quantized operands are
  bit-exact, the fp32 matmuls sum in each library's order).
- The quantized backend ignores ``shard_ways``, as JAX's
  ``lowbit_matmul_qd`` does: its ``k_block`` stays 128.
- The weight's wire path (``packed_wire`` / ``wire_fsdp_dim``) is exact and
  matches JAX's; the lint's three wire checks fire where JAX's do.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.core import lowbit as jlowbit  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import QuantConfig, lowbit  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import nn as L  # noqa: E402

ARCHS = sorted(configs.ARCHS)


def _contractions(cfg) -> set[int]:
    """The K of every quantized GEMM of ``cfg``'s model (meta device)."""
    with torch.device("meta"):
        model = lm.LM(cfg)
    ks = {m.w.shape[0] for m in model.modules() if isinstance(m, L.Linear)}
    ks |= {p.shape[1] for n, p in model.named_parameters()
           if n.endswith(("moe.w_gate", "moe.w_up", "moe.w_down"))}
    return ks


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_group_specs_match_jax(name):
    ours, ref = configs.get_config(name).qcfg(), jconfigs.get_config(name).qcfg()
    for k in sorted(_contractions(configs.get_config(name))):
        for rows in ((4, k), (2, 3, k)):
            for a, b in zip(ours.matmul_specs(rows, (k, 8)), ref.matmul_specs(rows, (k, 8))):
                assert a.block == b.block, (name, k, a.block, b.block)
    assert ours.shard_ways == ref.shard_ways == 16
    assert ours.packed_wire == ref.packed_wire


def test_the_alignment_narrows_where_jax_does():
    cfg = QuantConfig(shard_ways=16)
    assert [cfg._aligned_kb(k) for k in (256, 1024, 2048, 3584, 5120, 7168)] == \
        [JQuantConfig(shard_ways=16)._aligned_kb(k) for k in (256, 1024, 2048, 3584, 5120, 7168)] \
        == [16, 64, 128, 32, 64, 64]
    assert QuantConfig()._aligned_kb(256) == 128 and QuantConfig()._aligned_kb(40) == 40


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()), err_msg=what)


def _cfgs():
    return (QuantConfig(shard_ways=16, stochastic=False, backend="fake_quant"),
            JQuantConfig(shard_ways=16, stochastic=False))


def test_lowbit_matmul_with_shard_ways_matches_jax():
    rng = np.random.default_rng(22)
    x = (rng.standard_normal((4, 256)) * rng.uniform(0.1, 3.0, (1, 256))).astype(np.float32)
    w = (rng.standard_normal((256, 32)) * 0.2).astype(np.float32)
    g = rng.standard_normal((4, 32)).astype(np.float32)
    ours, ref = _cfgs()
    assert ours.matmul_specs(x.shape, w.shape)[0].block == (1, 16)
    y_ref = jax.jit(lambda a, b: jlowbit.lowbit_matmul(a, b, None, ref))(x, w)
    dx_ref, dw_ref = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jlowbit.lowbit_matmul(a, b, None, ref) * g), argnums=(0, 1)))(x, w)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = lowbit.lowbit_matmul(xt, wt, None, ours)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y, y_ref, "y")
    _close(xt.grad, dx_ref, "dx")
    _close(wt.grad, dw_ref, "dw")


def test_lowbit_matmul_stack_with_shard_ways_matches_jax():
    rng = np.random.default_rng(23)
    x = rng.standard_normal((3, 6, 256)).astype(np.float32)
    w = (rng.standard_normal((3, 256, 24)) * 0.2).astype(np.float32)
    g = rng.standard_normal((3, 6, 24)).astype(np.float32)
    ours, ref = _cfgs()

    def jfn(a, b):
        return jax.vmap(lambda xi, wi: jlowbit.lowbit_matmul(xi, wi, None, ref))(a, b)

    y_ref = jax.jit(jfn)(x, w)
    dx_ref, dw_ref = jax.jit(jax.grad(lambda a, b: jnp.sum(jfn(a, b) * g), argnums=(0, 1)))(x, w)
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = lowbit.lowbit_matmul_stack(xt, wt, None, ours)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y, y_ref, "y")
    _close(xt.grad, dx_ref, "dx")
    _close(wt.grad, dw_ref, "dw")


def test_quantized_backend_keeps_k_block():
    """``lowbit_matmul_qd`` reads ``k_block`` alone: under ``shard_ways=16``
    its K3 launches contract groups of 128, as without it, and give the same
    bits."""
    from repro_torch.kernels import launch, lowbit_matmul_qd, reset_launch_counts

    rng = np.random.default_rng(24)
    x = torch.from_numpy(rng.standard_normal((4, 256)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    outs = []
    for sw in (1, 16):
        reset_launch_counts()
        outs.append(lowbit_matmul_qd(x, w, None, QuantConfig(shard_ways=sw, stochastic=False)))
        k_blocks = {args[4] for (kernel, *args) in launch.RECORDED if kernel == "mls_matmul"}
        assert k_blocks == {128}, k_blocks
    reset_launch_counts()
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("packed_wire,wire", [(False, 0), (True, 0), (True, 1)])
def test_the_wire_path_is_exact_and_matches_jax(packed_wire, wire):
    """``quantize_operand(..., wire=True)`` through the packed codes and
    compact scales (``packed_wire``) or the unit values, at either FSDP dim:
    the same forward and gradients as JAX's, and as without the wire (the
    round trip is exact; ``wire_pin`` is the identity without bound rules)."""
    import dataclasses

    rng = np.random.default_rng(25)
    x = rng.standard_normal((6, 256)).astype(np.float32)
    w = (rng.standard_normal((256, 48)) * 0.2).astype(np.float32)
    g = rng.standard_normal((6, 48)).astype(np.float32)
    ours, ref = _cfgs()
    ours = dataclasses.replace(ours, packed_wire=packed_wire, wire_fsdp_dim=wire)
    ref = dataclasses.replace(ref, packed_wire=packed_wire, wire_fsdp_dim=wire)
    y_ref = jax.jit(lambda a, b: jlowbit.lowbit_matmul(a, b, None, ref))(x, w)
    dx_ref, dw_ref = jax.jit(jax.grad(
        lambda a, b: jnp.sum(jlowbit.lowbit_matmul(a, b, None, ref) * g), argnums=(0, 1)))(x, w)
    outs = []
    for cfg in (ours, _cfgs()[0]):
        xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
        y = lowbit.lowbit_matmul(xt, wt, None, cfg)
        (y * torch.from_numpy(g)).sum().backward()
        outs.append((y.detach(), xt.grad, wt.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    _close(outs[0][0], y_ref, "y")
    _close(outs[0][1], dx_ref, "dx")
    _close(outs[0][2], dw_ref, "dw")


def test_lint_checks_the_wire_fields_as_jax_does():
    import dataclasses

    from repro.analysis.lint import lint_quant_config as jlint
    from repro_torch.analysis.lint import lint_quant_config, lint_shipped_presets

    for kw in ({"shard_ways": 0}, {"wire_fsdp_dim": 2}, {"packed_wire": True},
               {"packed_wire": True, "wire_fsdp_dim": 1}, {"shard_ways": 16}):
        ours = lint_quant_config(dataclasses.replace(QuantConfig(), **kw))
        ref = jlint(dataclasses.replace(JQuantConfig(), **kw))
        for mine, theirs in ((ours.errors, ref.errors), (ours.warnings, ref.warnings)):
            pick = ("shard_ways", "wire_fsdp_dim", "packed_wire")
            assert len([m for m in mine if any(p in m for p in pick)]) == \
                len([m for m in theirs if any(p in m for p in pick)]), kw
    assert all(r.ok for r in lint_shipped_presets().values())
