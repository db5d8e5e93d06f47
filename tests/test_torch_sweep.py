"""The port's frontier sweep (``repro_torch.sweep``) against the JAX
package's (``repro.sweep``), on the CPU.

- **Grid parity.**  Every cell of the JAX smoke and full grids has the
  same ``cell_id`` and ``config_hash`` in the port, in the same order (the
  baselines of both packages key on the hash); every hash of the JAX
  committed baseline is a port cell; the port's chip grid is disjoint from
  both.  Each cell derives the same ``QuantConfig`` (CNN) or
  ``ModelConfig`` (LM) fields, with the JAX backend name "pallas" mapped
  to the port's "quantized".
- **Gate, report and record on the same rows.**  ``apply_gate``,
  ``build_baseline``, ``sabotage_baseline`` and ``frontier_table`` give
  equal output in both packages on rows made from the JAX committed
  baseline, with planted regressions, divergences, missing cells and
  envelope breaks (the unblessed-cell message names each package's own
  CLI, and is compared with that name swapped); ``make_payload`` gives the
  same keys.  The one departure: ``sabotage_baseline(..., "missing_cell",
  grid_name)`` drops a cell of the gated grid; the JAX package drops the
  baseline's first cell whatever the grid, so its full grid's negative
  control passes (shown here).
- **The runner against JAX's, fed JAX's weights (``convert``) and
  batches.**  The fp32 ResNet-20 and fp32 transformer smoke cells over 3
  steps: each step's loss within 1e-5 relative (seen: 2.2e-7 on
  ResNet-20); VGG-16's fp32 smoke cell over 1 step (past it the proxy
  parts at lr 0.05: the port's own draws diverge, and are blessed so).  One ``mls_e2m1/fake_quant`` ResNet-20 step and one
  ``transformer/mls_e2m4/pallas`` step (the port's K1/K3 plain versions,
  JAX's Pallas kernels in interpret mode), both with nearest rounding
  (key None; the two packages' stochastic streams differ) and a second
  step after the update: both losses within 1e-5 relative (seen: 7.3e-8
  and 0 at step 0).  JAX's step is built from its public functions as
  ``repro/sweep/runner.py`` builds it.
- **The CLI's exit codes**, on a JAX-written artifact, under sabotage and
  for ``--update-baseline`` of a partial or sabotaged run.
- **The port alone.**  Two smoke cells train on the CPU, pass the gate
  against the port's committed baseline under ``--only`` and give equal
  rows when run again; the committed baseline covers the smoke, full and
  chip grids.
"""
import copy
import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.configs as jconfigs  # noqa: E402
import repro.sweep.gate as jgate  # noqa: E402
import repro.sweep.grid as jgrid  # noqa: E402
import repro.sweep.record as jrecord  # noqa: E402
import repro.sweep.report as jreport  # noqa: E402
from repro.core import QuantConfig as JQuantConfig  # noqa: E402
from repro.data import make_cifar_iterator as jax_cifar_iterator  # noqa: E402
from repro.data import make_lm_iterator as jax_lm_iterator  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.models.cnn import CNNConfig as JCNNConfig  # noqa: E402
from repro.models.cnn import apply_cnn  # noqa: E402
from repro.models.cnn import init_cnn as jax_init_cnn  # noqa: E402
from repro.optim import adamw_init as jadamw_init  # noqa: E402
from repro.optim import adamw_update as jadamw_update  # noqa: E402
from repro.optim import sgdm_init as jsgdm_init  # noqa: E402
from repro.optim import sgdm_update as jsgdm_update  # noqa: E402
from repro.sweep import __main__ as jcli  # noqa: E402
from repro_torch.convert import cnn_params_from_jax, lm_params_from_jax  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.cnn import build_cnn  # noqa: E402
from repro_torch.sweep import __main__ as cli  # noqa: E402
from repro_torch.sweep import gate, grid, record, report, runner  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JAX_GRIDS = {"smoke": jgrid.smoke_grid, "full": jgrid.full_grid}
TRAJECTORY_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny models: one intra-op thread, so that the test workers sharing
    the machine do not spin against each other (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# grids
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["smoke", "full"])
def test_grid_cells_and_hashes_equal_the_jax_grids(name):
    theirs = [(c.cell_id(), c.config_hash()) for c in JAX_GRIDS[name]()]
    ours = [(c.cell_id(), c.config_hash()) for c in grid.GRIDS[name]()]
    assert ours == theirs
    assert [dataclasses.asdict(c) for c in grid.GRIDS[name]()] == [
        dataclasses.asdict(c) for c in JAX_GRIDS[name]()]


def test_jax_baseline_hashes_are_port_cells_and_the_chip_grid_is_disjoint():
    port = {c.config_hash() for n in ("smoke", "full") for c in grid.GRIDS[n]()}
    assert set(jgate.load_baseline()["cells"]) <= port
    chip = [c.config_hash() for c in grid.chip_grid()]
    assert len(chip) == len(set(chip)) == 8
    assert not set(chip) & port
    assert {(c.fmt, c.backend, c.grouping) for c in grid.chip_grid()} == {
        ("fp32", "fake_quant", "nc"), ("mls_e2m4", "fake_quant", "nc"),
        ("mls_e2m1", "fake_quant", "nc"), ("fix_e0m4", "fake_quant", "nc"),
        ("mls_e2m4", "pallas", "nc"), ("mls_e2m1", "pallas", "nc"),
        ("mls_e2m1", "pallas", "c"), ("mls_e2m1", "pallas", "none")}
    for c in grid.chip_grid():
        assert (c.arch, c.width, c.hw, c.batch, c.steps, c.lr) == (
            "resnet20", 1.0, 32, 128, 40, 0.05)
        assert c.envelope_acc == (None if c.grouping != "nc" else 0.35)


def _fields(obj) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if type(v).__name__ == "EMFormat":  # one class per package
            v = (v.e, v.m)
        out[f.name] = v
    return out


@pytest.mark.parametrize("name", ["smoke", "full"])
def test_each_cell_derives_the_jax_numerics(name):
    """What ``repro/sweep/runner.py`` builds for each cell (its
    ``QuantConfig`` for a CNN, its ``ModelConfig`` for an LM) against the
    port's, field by field where both packages have the field."""
    for jc, c in zip(JAX_GRIDS[name](), grid.GRIDS[name]()):
        if c.is_cnn:
            ours = runner.cell_qcfg(c)
            assert runner.cell_cnn_config(c).width_mult == c.width
            if jc.emformat is None:
                assert ours is None
                continue
            theirs = JQuantConfig(fmt=jc.emformat, grouping=jc.grouping, backend=jc.backend)
            a, b = _fields(ours), _fields(theirs)
            assert a.pop("backend") == {"pallas": "quantized"}.get(b.pop("backend"), jc.backend)
            assert {k: v for k, v in a.items() if k in b} == {k: b[k] for k in a if k in b}
            assert set(a) - set(b) == set(), set(a) - set(b)
        else:
            jcfg = jconfigs.get_smoke_config(jgrid.LM_ARCHS[jc.arch])
            theirs = dataclasses.replace(
                jcfg, quant=jc.emformat is not None,
                fmt=jc.emformat if jc.emformat is not None else jcfg.fmt,
                quant_backend=jc.backend)
            ours = runner.cell_model_config(c)
            assert _fields(ours) == _fields(theirs)
            if ours.quant:
                assert ours.qcfg().backend == {"pallas": "quantized"}.get(
                    jc.backend, jc.backend)


# ---------------------------------------------------------------------------
# grid semantics (the JAX package's cases, run on both packages)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pkg", [jgrid, grid], ids=["jax", "port"])
def test_expand_grid_product_dedup_and_hash_semantics(pkg):
    cells = pkg.expand_grid([{"arch": ["resnet20"], "fmt": ["fp32", "mls_e2m1"],
                              "backend": ["fake_quant", "pallas"], "steps": 4}])
    assert {(c.fmt, c.backend) for c in cells} == {
        ("fp32", "fake_quant"), ("fp32", "pallas"),
        ("mls_e2m1", "fake_quant"), ("mls_e2m1", "pallas")}
    block = {"arch": "resnet20", "fmt": "mls_e2m1", "steps": 4}
    assert len(pkg.expand_grid([block, dict(block), {**block, "envelope_acc": 0.5}])) == 1
    c = pkg.Cell(arch="resnet20", fmt="mls_e2m1", steps=4)
    assert c.config_hash() == pkg.Cell(arch="resnet20", fmt="mls_e2m1", steps=4).config_hash()
    assert c.config_hash() != pkg.Cell(arch="resnet20", fmt="mls_e2m4", steps=4).config_hash()
    assert c.config_hash() != pkg.Cell(arch="resnet20", fmt="mls_e2m1", steps=5).config_hash()
    assert c.config_hash() == pkg.Cell(arch="resnet20", fmt="mls_e2m1", steps=4,
                                       envelope_acc=0.1).config_hash()
    for bad in ({"arch": "resnet20", "fmt": "bf16"}, {"arch": "alexnet", "fmt": "fp32"},
                {"arch": "resnet20", "fmt": "fp32", "backend": "cuda"},
                {"arch": "resnet20", "fmt": "fp32", "backend": "quantized"}):
        with pytest.raises(ValueError):
            pkg.Cell(**bad)


@pytest.mark.parametrize("name", ["smoke", "full", "chip"])
def test_grid_has_unique_hashes_and_an_fp32_reference_for_its_envelopes(name):
    cells = grid.GRIDS[name]()
    hashes = [c.config_hash() for c in cells]
    assert len(hashes) == len(set(hashes))
    assert {c.backend for c in cells} == {"fake_quant", "pallas"}
    for c in cells:
        if c.envelope_acc is not None or c.envelope_loss is not None:
            assert any(r.arch == c.arch and r.fmt == "fp32" and r.backend == "fake_quant"
                       and r.grouping == "nc" for r in cells), c.cell_id()


# ---------------------------------------------------------------------------
# gate, report and record on the same rows
# ---------------------------------------------------------------------------
def _rows_of(name: str, base: dict) -> list[dict]:
    """Runner rows for the JAX grid ``name`` carrying the JAX committed
    baseline's metrics (a run that exactly repeats the blessing)."""
    rows = []
    for c in JAX_GRIDS[name]():
        e = base["cells"][c.config_hash()]
        row = {"name": f"sweep/{c.cell_id()}", "cell_id": c.cell_id(),
               "config_hash": c.config_hash(), "arch": c.arch, "fmt": c.fmt,
               "backend": c.backend, "grouping": c.grouping, "steps": c.steps,
               "final_loss": e["final_loss"], "final_acc": e["final_acc"],
               "diverged": e["diverged"], "wall_time_s": 1.0}
        if c.envelope_acc is not None:
            row["envelope_acc"] = c.envelope_acc
        if c.envelope_loss is not None:
            row["envelope_loss"] = c.envelope_loss
        rows.append(row)
    return rows


def _find(rows, cid):
    return next(r for r in rows if r["cell_id"] == cid)


def _plant(case: str, rows: list[dict], base: dict) -> tuple[list[dict], dict, str | None]:
    rows, base = copy.deepcopy(rows), copy.deepcopy(base)
    grid_name = "smoke"
    r = _find(rows, "resnet20/mls_e2m1/fake_quant")
    if case == "loss_regression":
        r["final_loss"] += 0.3
    elif case == "acc_regression":
        r["final_acc"] -= 0.25
    elif case == "tolerance_override":
        r["final_loss"] += 0.3
        base["cells"][r["config_hash"]]["loss_tol"] = 1.0
    elif case == "new_divergence":
        r["diverged"], r["final_loss"] = True, None
    elif case == "known_divergence":
        r["diverged"] = True
        base["cells"][r["config_hash"]]["diverged"] = True
    elif case == "unknown_and_missing":
        r["config_hash"] = "fresh0000000"
    elif case == "partial_run":
        r["config_hash"] = "fresh0000000"
        grid_name = None
    elif case == "envelope_break":
        r["final_acc"] = _find(rows, "resnet20/fp32/fake_quant")["final_acc"] - 0.4
        base["cells"][r["config_hash"]]["final_acc"] = r["final_acc"]
    elif case == "no_fp32_reference":
        rows.remove(_find(rows, "resnet20/fp32/fake_quant"))
        grid_name = None
    elif case == "loss_envelope_break":
        r = _find(rows, "transformer/mls_e2m1/fake_quant")
        r["final_loss"] = _find(rows, "transformer/fp32/fake_quant")["final_loss"] + 0.7
        base["cells"][r["config_hash"]]["final_loss"] = r["final_loss"]
    elif case.startswith("sabotage_"):
        base = jgate.sabotage_baseline(base, case.removeprefix("sabotage_"))
    return rows, base, grid_name


GATE_CASES = ["identical", "loss_regression", "acc_regression", "tolerance_override",
              "new_divergence", "known_divergence", "unknown_and_missing", "partial_run",
              "envelope_break", "no_fp32_reference", "loss_envelope_break",
              "sabotage_regress", "sabotage_missing_cell"]
PASSING = {"identical", "tolerance_override", "known_divergence"}


def _same_messages(ours: list[str]) -> list[str]:
    return [m.replace("python -m repro_torch.sweep", "python -m repro.sweep") for m in ours]


@pytest.mark.parametrize("case", GATE_CASES)
def test_gate_equals_the_jax_gate_on_planted_runs(case):
    rows, base, grid_name = _plant(case, _rows_of("smoke", jgate.load_baseline()),
                                   jgate.load_baseline())
    theirs = jgate.apply_gate(rows, base, grid_name=grid_name)
    ours = gate.apply_gate(rows, base, grid_name=grid_name)
    assert _same_messages(ours) == theirs
    assert (not ours) == (case in PASSING), ours


def test_sabotage_and_build_baseline_equal_the_jax_ones():
    base = jgate.load_baseline()
    for mode in gate.SABOTAGE_MODES:
        assert gate.sabotage_baseline(base, mode) == jgate.sabotage_baseline(base, mode)
    with pytest.raises(ValueError):
        gate.sabotage_baseline(base, "nope")
    with pytest.raises(ValueError):
        gate.sabotage_baseline({"cells": {}})
    assert gate.sabotage_baseline(base, "regress") != base  # never in place
    smoke, full = _rows_of("smoke", base), _rows_of("full", base)
    a = gate.build_baseline(smoke, "smoke")
    assert a == jgate.build_baseline(smoke, "smoke")
    a = gate.build_baseline(full, "full", a)
    assert a == jgate.build_baseline(full, "full", jgate.build_baseline(smoke, "smoke"))
    assert a == base  # the committed JAX baseline, rebuilt
    a["cells"][smoke[0]["config_hash"]]["acc_tol"] = 0.5
    b = gate.build_baseline(smoke[1:], "smoke", a)
    assert b == jgate.build_baseline(smoke[1:], "smoke", a)
    assert smoke[0]["config_hash"] not in b["cells"]


def test_missing_cell_sabotage_drops_a_cell_of_the_gated_grid():
    """The JAX control drops the baseline's first cell, a smoke cell, so a
    full-grid run still passes under it; the port drops a full-grid cell."""
    base = jgate.load_baseline()
    full = _rows_of("full", base)
    assert jgate.apply_gate(full, jgate.sabotage_baseline(base, "missing_cell"), "full") == []
    fails = gate.apply_gate(full, gate.sabotage_baseline(base, "missing_cell", "full"), "full")
    assert len(fails) == 1 and "not in baseline" in fails[0]
    with pytest.raises(ValueError, match="no baseline cell"):
        gate.sabotage_baseline(base, "missing_cell", "chip")


def test_frontier_table_equals_the_jax_table():
    base = jgate.load_baseline()
    rows = _rows_of("smoke", base) + _rows_of("full", base)
    _find(rows, "resnet20/mls_e2m1/fake_quant/g_none").update(diverged=True)
    _find(rows, "moe/mls_e2m4/fake_quant").update(final_loss=None)
    md = report.frontier_table(rows)
    assert md == jreport.frontier_table(rows)
    assert "| resnet20 (grouping=none) | fake_quant | — | — | **DIVERGED** | — |" in md
    assert report.frontier_table(rows, title="t") == jreport.frontier_table(rows, title="t")


def test_make_payload_has_the_jax_keys():
    ours = record.make_payload("s", [{"name": "a"}, {"name": "b"}], quick=True,
                               extra={"grid": "smoke"}, device="cpu")
    theirs = jrecord.make_payload("s", [{"name": "a"}, {"name": "b"}], quick=True,
                                  extra={"grid": "smoke"})
    assert list(ours) == list(theirs)
    assert ours["backend"] == "cpu" and ours["schema_version"] == record.SCHEMA_VERSION == 1
    assert ours["git_sha"] == theirs["git_sha"]
    assert ours["rows"] == theirs["rows"]
    assert record.git_sha() == jrecord.git_sha()


# ---------------------------------------------------------------------------
# the runner against JAX's, fed JAX's weights and batches
# ---------------------------------------------------------------------------
def _jax_cnn_run(cell, steps: int, nearest: bool):
    """JAX's losses for ``steps`` steps of a CNN cell (the step of
    ``repro/sweep/runner.py``), its initial parameters and its batches."""
    cfg = JCNNConfig(arch=cell.arch, num_classes=10, width_mult=cell.width, in_hw=cell.hw)
    qcfg = None
    if cell.emformat is not None:
        qcfg = JQuantConfig(fmt=jgrid.FORMATS[cell.fmt], grouping=cell.grouping,
                            backend=cell.backend)
    params = jax_init_cnn(jax.random.key(cell.seed), cfg)
    init = jax.tree.map(np.asarray, params)
    opt = jsgdm_init(params)
    nxt, ds = jax_cifar_iterator(batch=cell.batch, hw=cell.hw, num_classes=10, seed=cell.seed)

    @jax.jit
    def step(params, opt, batch, i):
        def loss_fn(p):
            key = None if nearest else jax.random.fold_in(jax.random.key(1), i)
            logits = apply_cnn(p, batch["image"], cfg, qcfg, key)
            ll = jax.nn.log_softmax(logits)
            return -jnp.take_along_axis(ll, batch["label"][:, None], 1).mean()

        loss, g = jax.value_and_grad(loss_fn)(params)
        params, opt = jsgdm_update(g, opt, params, lr=cell.lr)
        return params, opt, loss

    losses, batches = [], []
    for i in range(steps):
        batch, ds = nxt(ds)
        batches.append({"image": torch.from_numpy(np.array(batch["image"])),
                        "label": torch.from_numpy(np.array(batch["label"])).long()})
        params, opt, loss = step(params, opt, batch, jnp.int32(i))
        losses.append(float(loss))
    return losses, init, batches


def _jax_lm_run(cell, steps: int, nearest: bool):
    """JAX's losses for ``steps`` steps of an LM cell, its initial
    parameters and its batches."""
    jcfg = jconfigs.get_smoke_config(jgrid.LM_ARCHS[cell.arch])
    jcfg = dataclasses.replace(
        jcfg, quant=cell.emformat is not None,
        fmt=jgrid.FORMATS[cell.fmt] if cell.emformat is not None else jcfg.fmt,
        quant_backend=cell.backend)
    params = jlm.init_lm(jax.random.key(cell.seed), jcfg)
    init = jax.tree.map(np.asarray, params)
    opt = jadamw_init(params)
    nxt, ds = jax_lm_iterator(cell.batch, cell.seq, jcfg.vocab, seed=cell.seed)

    @jax.jit
    def step(p, opt, batch, i):
        key = None if nearest else jax.random.fold_in(jax.random.key(1), i)
        (loss, _), g = jax.value_and_grad(jlm.lm_loss, has_aux=True)(p, batch, jcfg, key)
        p, opt = jadamw_update(g, opt, p, lr=1e-3)
        return p, opt, loss

    losses, batches = [], []
    for i in range(steps):
        batch, ds = nxt(ds)
        batches.append({"tokens": torch.from_numpy(np.array(batch["tokens"])).long()})
        params, opt, loss = step(params, opt, batch, jnp.int32(i))
        losses.append(float(loss))
    return losses, init, batches


@pytest.mark.parametrize("cell_id,steps,nearest", [
    ("resnet20/fp32/fake_quant", 3, False),
    ("transformer/fp32/fake_quant", 3, False),
    ("vgg16/fp32/fake_quant", 1, False),
    ("resnet20/mls_e2m1/fake_quant", 2, True),
    ("transformer/mls_e2m4/pallas", 2, True),
])
def test_fed_runner_follows_the_jax_runner(cell_id, steps, nearest):
    cell = next(c for c in grid.smoke_grid() if c.cell_id() == cell_id)
    jcell = next(c for c in jgrid.smoke_grid() if c.cell_id() == cell_id)
    if cell.is_cnn:
        theirs, init, batches = _jax_cnn_run(jcell, steps, nearest)
        model = build_cnn(runner.cell_cnn_config(cell))
        model.load_state_dict(cnn_params_from_jax(init))
    else:
        theirs, init, batches = _jax_lm_run(jcell, steps, nearest)
        cfg = runner.cell_model_config(cell)
        model = lm.LM(cfg)
        model.load_state_dict(lm_params_from_jax(init, cfg))
    traj = runner.train_cell(dataclasses.replace(cell, steps=steps), "cpu", model=model,
                             batches=batches, rounding_seed=None if nearest else 1)
    assert len(traj.losses) == len(traj.step_s) == steps
    assert (traj.accs is None) == (not cell.is_cnn)
    for i, (a, b) in enumerate(zip(traj.losses, theirs)):
        assert abs(a - b) <= TRAJECTORY_RTOL * abs(b), (i, a, b)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------
def _artifact(tmp_path, rows, grid_name="smoke", name="rows.json") -> Path:
    """A JAX-written BENCH_accuracy.json."""
    path = tmp_path / name
    jrecord.write_json(str(path), jrecord.make_payload("frontier_sweep", rows, quick=True,
                                                       extra={"grid": grid_name}))
    return path


def test_cli_gates_a_jax_written_artifact(tmp_path):
    rows = _rows_of("smoke", jgate.load_baseline())
    bpath = tmp_path / "baseline.json"
    bpath.write_text(json.dumps(gate.build_baseline(rows, "smoke")))
    rpath = _artifact(tmp_path, rows)
    args = ["--from", str(rpath), "--baseline", str(bpath)]
    assert cli.main(["--gate", *args]) == 0
    assert cli.main(["--gate", "--sabotage", *args]) == 1
    assert cli.main(["--gate", "--sabotage", "missing_cell", *args]) == 1
    bad = copy.deepcopy(rows)
    _find(bad, "resnet20/mls_e2m1/fake_quant").update(final_loss=9.0, diverged=True)
    rbad = _artifact(tmp_path, bad, name="bad.json")
    assert cli.main(["--gate", "--from", str(rbad), "--baseline", str(bpath)]) == 1
    assert cli.main(["--from", str(rbad), "--baseline", str(bpath)]) == 0  # report only
    md = tmp_path / "frontier.md"
    assert cli.main(["--gate", *args, "--markdown", str(md)]) == 0
    assert md.read_text() == jreport.frontier_table(
        rows, title="Bit-width × architecture frontier (smoke grid)")
    # the JAX CLI on the same files
    assert jcli.main(["--gate", *args]) == 0
    assert jcli.main(["--gate", "--sabotage", *args]) == 1


def test_cli_refuses_to_bless_a_partial_or_sabotaged_run(tmp_path, capsys):
    rows = _rows_of("smoke", jgate.load_baseline())
    bpath = tmp_path / "b.json"
    rpath = _artifact(tmp_path, rows)
    assert cli.main(["--from", str(rpath), "--sabotage", "--update-baseline",
                     "--baseline", str(bpath)]) == 2
    partial = _artifact(tmp_path, rows[:2], grid_name="partial", name="partial.json")
    assert cli.main(["--from", str(partial), "--update-baseline",
                     "--baseline", str(bpath)]) == 2
    assert cli.main(["--smoke", "--only", "resnet20/fp32", "--update-baseline",
                     "--baseline", str(bpath), "--device", "cpu"]) == 2
    assert "refusing" in capsys.readouterr().err
    assert not bpath.exists()
    assert cli.main(["--from", str(rpath), "--update-baseline",
                     "--baseline", str(bpath)]) == 0
    assert json.loads(bpath.read_text()) == jgate.build_baseline(rows, "smoke")


@pytest.mark.parametrize("mode", ["--smoke", "--full", "--chip"])
def test_cli_lists_each_grid_and_refuses_an_unmatched_only(mode, capsys):
    assert cli.main([mode, "--only", "definitely-not-a-cell", "--list"]) == 2
    assert "matches no cell" in capsys.readouterr().err
    assert cli.main([mode, "--list"]) == 0
    out = capsys.readouterr().out
    name = mode.removeprefix("--")
    assert out.splitlines() == [f"{c.cell_id()}  hash={c.config_hash()}  steps={c.steps}"
                                for c in grid.GRIDS[name]()]


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------
def test_smoke_cells_pass_the_committed_gate_and_repeat(tmp_path):
    """The smoke grid's four ResNet-20 cells (``--only resnet20``: the
    envelope cells need their fp32 reference in the same run) on the CPU
    pass the gate against the port's committed baseline; two of them, run
    again, give equal rows."""
    out = tmp_path / "rows.json"
    assert cli.main(["--smoke", "--only", "resnet20/", "--device", "cpu", "--gate",
                     "--out", str(out)]) == 0
    payload = json.loads(out.read_text())
    assert payload["backend"] == "cpu" and payload["grid"] == "partial"
    rows = {r["cell_id"]: r for r in payload["rows"]}
    assert len(rows) == 4
    drop = ("wall_time_s", "schema_version", "git_sha")
    for cid in ("resnet20/fp32/fake_quant", "resnet20/mls_e2m1/fake_quant"):
        cell = next(c for c in grid.smoke_grid() if c.cell_id() == cid)
        again = runner.run_cell(cell, "cpu")
        assert {k: v for k, v in rows[cid].items() if k not in drop} == {
            k: v for k, v in again.items() if k not in drop}
        assert not again["diverged"] and again["config_hash"] in gate.load_baseline()["cells"]


@pytest.mark.parametrize("name", ["smoke", "full", "chip"])
def test_committed_baseline_covers_the_grid(name):
    base = gate.load_baseline()
    assert base["schema_version"] == 1
    assert base == json.loads(gate.BASELINE_PATH.read_text())
    for c in grid.GRIDS[name]():
        entry = base["cells"].get(c.config_hash())
        assert entry is not None, c.cell_id()
        assert name in entry["grids"] and entry["cell_id"] == c.cell_id()
    assert set(gate.BASELINE_PATH.parent.iterdir()) == {gate.BASELINE_PATH}


def test_table2_benchmark_rides_on_the_port_runner():
    """The port's Table II has the JAX file's variants and proxy cells."""
    import importlib.util

    def load(name):
        spec = importlib.util.spec_from_file_location(name, ROOT / "benchmarks" / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module

    ours, theirs = load("torch_table2_accuracy"), load("table2_accuracy")
    assert ours.VARIANTS == theirs.VARIANTS
    for kw in ours.VARIANTS.values():
        a = grid.Cell(arch="resnet20", batch=32, hw=16, width=0.25, steps=40, **kw)
        b = jgrid.Cell(arch="resnet20", batch=32, hw=16, width=0.25, steps=40, **kw)
        assert a.config_hash() == b.config_hash()
