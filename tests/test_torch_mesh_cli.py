"""The mesh's surfaces beside the reference's, on the CPU: the CLI's
``--mesh``/``--overlap`` (``.gol`` files byte for byte, the master
header's writers, strict mode with the effective mesh, the host
backends' refusal, resume of a meshed run), with each divergence from the
reference's CLI pinned; ``validate_mesh`` message for message; the comm
policy's mesh branches; the serve layer's refusal of a mesh; and the
verifier's ``ir-collective`` on seeded faults."""

import contextlib
import filecmp
import io
import os

import numpy as np
import pytest
import torch

from mpi_tpu.cli import main as jax_main
from mpi_tpu.config import ConfigError as JaxConfigError
from mpi_tpu.config import validate_mesh as jax_validate_mesh
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.parallel.policy import FRINGE_DIVISOR as JAX_FRINGE
from mpi_tpu.parallel.policy import LATENCY_TABLE as JAX_TABLE
from mpi_tpu.parallel.policy import choose_comm_policy as jax_choose
from mpi_tpu_torch import golio
from mpi_tpu_torch.analysis.ir import checks
from mpi_tpu_torch.analysis.ir.harness import record_cell
from mpi_tpu_torch.analysis.ir.matrix import cell_by_id
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import ConfigError, GolConfig, validate_mesh
from mpi_tpu_torch.models.rules import LIFE, rule_from_name
from mpi_tpu_torch.parallel import halo
from mpi_tpu_torch.parallel import step as port_step
from mpi_tpu_torch.parallel.mesh import make_mesh
from mpi_tpu_torch.parallel.policy import (
    FRINGE_DIVISOR, LATENCY_TABLE, choose_comm_policy,
    probe_collective_latency_us, resolve_auto,
)
from mpi_tpu_torch.serve.session import SessionManager
from mpi_tpu_torch.utils.hashinit import init_tile_np


def _files(d):
    return sorted(f for f in os.listdir(d) if f.endswith((".gol", ".golp")))


def _both_cli(tmp_path, args, name="r"):
    common = ["--save", "--quiet", "--name", name]
    j, p = str(tmp_path / "j"), str(tmp_path / "p")
    assert jax_main(args + common + ["--out-dir", j, "--backend", "tpu"]) == 0
    assert port_main(args + common + ["--out-dir", p, "--device", "cpu"]) == 0
    return j, p


@pytest.mark.parametrize("extra", [
    ["--mesh", "2x4"],
    ["--mesh", "2x4", "--boundary", "dead", "--comm-every", "2"],
    ["--mesh", "2x4", "--overlap", "--comm-every", "2"],
    ["--mesh", "1x2", "--rule", "bosco", "--overlap"],
    ["--mesh", "8x1", "--rule", "R2,B8-12,S9-14", "--boundary", "dead"],
], ids=["life", "dead-k2", "overlap", "bosco", "r2-8x1"])
def test_cli_mesh_files_equal_the_reference(tmp_path, extra):
    j, p = _both_cli(tmp_path, ["64", "256", "4", "8", "--seed", "5"] + extra)
    assert _files(j) == _files(p) and _files(p)
    for f in _files(j):
        assert filecmp.cmp(os.path.join(j, f), os.path.join(p, f),
                           shallow=False), f
    mi, mj = (int(v) for v in extra[1].split("x"))
    assert golio.read_master(golio.master_path(p, "r"))[4] == mi * mj
    assert golio.iteration_tile_pids(p, "r", 8) == list(range(mi * mj))


def test_cli_seam_band_deeper_than_k2_like_the_reference(tmp_path):
    """Bosco at comm_every 4 on a padded periodic 1x2 mesh: 20 cells of
    seam band depth, past K2's 16, stepped in chunks; the files equal the
    reference CLI's (the master alone without snapshots, then every tile
    with a snapshot each 4 generations) and the final board the
    oracle's."""
    for gap in ("0", "4"):
        j, p = _both_cli(tmp_path / gap, ["20", "84", gap, "4", "--rule",
                                          "bosco", "--mesh", "1x2",
                                          "--comm-every", "4"])
        assert _files(j) == _files(p) and _files(p)
        for f in _files(j):
            assert filecmp.cmp(os.path.join(j, f), os.path.join(p, f),
                               shallow=False), f
    np.testing.assert_array_equal(
        golio.load_snapshot(p, "r", 4),
        evolve_np(init_tile_np(20, 84, 0), 4, rule_from_name("bosco"),
                  "periodic"))


def test_cli_padded_mesh_drops_the_pad_shards_like_the_reference(tmp_path):
    """32x32 periodic on 2x4 pads each 8-column shard to a word: only
    shard column 0 holds real cells, so pids {0, 4} are written."""
    j, p = _both_cli(tmp_path, ["32", "32", "8", "16", "--seed", "5",
                                "--mesh", "2x4"])
    assert _files(j) == _files(p)
    for f in _files(j):
        assert filecmp.cmp(os.path.join(j, f), os.path.join(p, f),
                           shallow=False), f
    assert golio.iteration_tile_pids(p, "r", 16) == [0, 4]
    np.testing.assert_array_equal(
        golio.load_snapshot(p, "r", 16),
        evolve_np(init_tile_np(32, 32, 5), 16, rule_from_name("life"),
                  "periodic"))


def test_cli_resume_of_a_meshed_run(tmp_path):
    """A meshed run resumed from its snapshot through ``golio`` on another
    mesh ends where one run of all the steps ends."""
    out = str(tmp_path)
    base = ["64", "256", "4", "8", "--seed", "3", "--device", "cpu",
            "--quiet", "--out-dir", out, "--save"]
    assert port_main(base + ["--mesh", "2x4", "--name", "m"]) == 0
    assert port_main(["64", "256", "4", "4", "--seed", "3", "--device",
                      "cpu", "--quiet", "--out-dir", out, "--save",
                      "--mesh", "2x2", "--resume", "m@8"]) == 0
    np.testing.assert_array_equal(
        golio.assemble(out, "m", 12),
        evolve_np(init_tile_np(64, 256, 3), 12, rule_from_name("life"),
                  "periodic"))
    assert golio.read_master(golio.master_path(out, "m"))[4] == 4


def test_cli_strict_judges_the_effective_mesh(tmp_path, capsys):
    out = ["--out-dir", str(tmp_path), "--quiet", "--device", "cpu"]
    assert port_main(["32", "32", "8", "4", "--strict", "--mesh", "2x4"]
                     + out) == 2
    assert "perfect square mesh (effective mesh 2x4)" in \
        capsys.readouterr().err
    assert port_main(["32", "32", "8", "4", "--strict", "--mesh", "2x2"]
                     + out) == 0
    # divergence: without --mesh the port runs one device, (1, 1), which
    # strict accepts; the reference takes its 8 virtual devices (2x4) and
    # refuses
    assert port_main(["32", "32", "8", "4", "--strict"] + out) == 0
    assert jax_main(["32", "32", "8", "4", "--strict", "--backend", "tpu",
                     "--out-dir", str(tmp_path / "j"), "--quiet"]) == 2


def test_cli_default_is_one_device_where_the_reference_takes_all(tmp_path):
    """Pinned divergence: the port's default mesh is the one device
    ``--device`` names (one tile); the reference's is every device it
    sees (8 tiles on its test mesh)."""
    j, p = _both_cli(tmp_path, ["32", "64", "4", "4"])
    assert golio.read_master(golio.master_path(p, "r"))[4] == 1
    assert golio.read_master(golio.master_path(j, "r"))[4] == 8
    np.testing.assert_array_equal(golio.load_snapshot(p, "r", 4),
                                  golio.load_snapshot(j, "r", 4))


def test_cli_mesh_refused_for_the_host_backends(tmp_path, capsys):
    for backend in ("serial", "cpp", "cpp-par"):
        args = ["32", "32", "8", "4", "--backend", backend, "--mesh", "2x2",
                "--out-dir", str(tmp_path / backend), "--quiet"]
        assert port_main(args) == 2
        assert "mesh_shape applies to the cuda backend only" in \
            capsys.readouterr().err
        assert not os.path.exists(tmp_path / backend)
    assert port_main(["32", "32", "8", "4", "--mesh", "2by2", "--device",
                      "cpu", "--out-dir", str(tmp_path)]) == 2
    assert "--mesh must look like 2x4" in capsys.readouterr().err


def test_cli_mesh_on_the_card_needs_every_card(tmp_path, capsys,
                                               monkeypatch):
    """--mesh 2x2 --device cuda on one card: the reference's message,
    before any file is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    out = tmp_path / "x"
    assert port_main(["64", "64", "0", "4", "--mesh", "2x2", "--out-dir",
                      str(out)]) == 2
    assert "mesh shape (2, 2) needs 4 devices, have 1" in \
        capsys.readouterr().err
    assert not out.exists()


def test_cli_comm_every_auto_on_a_mesh(tmp_path, capsys, monkeypatch):
    import mpi_tpu_torch.parallel.policy as policy

    monkeypatch.setattr(policy, "probe_collective_latency_us",
                        lambda mesh, reps=5: 200.0)
    assert port_main(["64", "256", "0", "6", "--mesh", "2x2", "--comm-every",
                      "auto", "--device", "cpu", "--out-dir",
                      str(tmp_path)]) == 0
    assert "comm policy auto: comm_every=4, overlap=True" in \
        capsys.readouterr().out


@pytest.mark.parametrize("rows,cols,shape,ghost", [
    (64, 64, (2, 2), 1), (64, 64, (3, 2), 1), (64, 60, (2, 8), 1),
    (8, 64, (2, 1), 2), (64, 8, (1, 2), 4), (8, 8, (1, 1), 9),
    (64, 64, (0, 2), 1), (16, 64, (1, 1), 16),
])
def test_validate_mesh_message_for_message(rows, cols, shape, ghost):
    try:
        jax_validate_mesh(rows, cols, shape, ghost)
        want = None
    except JaxConfigError as e:
        want = str(e)
    try:
        validate_mesh(rows, cols, shape, ghost)
        got = None
    except ConfigError as e:
        got = str(e)
    assert got == want


def test_config_refusals_on_a_mesh():
    with pytest.raises(ConfigError, match="sparse_tile and overlap are "
                       "exclusive"):
        GolConfig(rows=64, cols=64, steps=1, sparse_tile=32, overlap=True)
    with pytest.raises(ConfigError, match="overlap applies to the cuda"):
        GolConfig(rows=64, cols=64, steps=1, overlap=True, backend="serial")
    with pytest.raises(ConfigError, match="too small for a 8-deep halo"):
        GolConfig(rows=32, cols=64, steps=1, comm_every=8, mesh_shape=(2, 1))
    GolConfig(rows=64, cols=64, steps=1, comm_every=8, mesh_shape=(2, 2))


def test_policy_tables_equal_the_reference():
    assert LATENCY_TABLE == JAX_TABLE and FRINGE_DIVISOR == JAX_FRINGE


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("rule", ["life", "R2,B8-12,S9-14", "bosco",
                                  "B03/S23"])
@pytest.mark.parametrize("tile", [(32, 32), (128, 64), (512, 512),
                                  (16, 4096)])
@pytest.mark.parametrize("lat", [5.0, 100.0, 400.0, 5000.0])
def test_choose_comm_policy_equals_the_reference(n, rule, tile, lat):
    ours = choose_comm_policy(n, rule_from_name(rule), tile[0], tile[1], lat)
    theirs = jax_choose(n, jax_rule_from_name(rule), tile[0], tile[1], lat)
    assert ours == theirs


def test_choose_comm_policy_is_the_mesh_policy_only():
    # the reference also answers for one device here; the port answers one
    # device through resolve_auto(config) alone
    with pytest.raises(ValueError, match="mesh policy"):
        choose_comm_policy(1, rule_from_name("life"), 64, 64, 5.0)


def test_resolve_auto_on_a_mesh():
    cfg = GolConfig(rows=256, cols=256, steps=1, mesh_shape=(2, 2))
    assert resolve_auto(cfg, (2, 2), latency_us=1000.0) == (8, True)
    assert resolve_auto(cfg, (2, 2), latency_us=10.0) == (1, True)
    one = GolConfig(rows=64, cols=4096, steps=1)
    assert resolve_auto(one, (1, 1)) == (resolve_auto(one), False)
    mesh = make_mesh((2, 2), platform="cpu")
    lat = probe_collective_latency_us(mesh, reps=3)
    assert lat > 0
    k, ov = resolve_auto(cfg, (2, 2), mesh=mesh)
    assert 1 <= k <= 8


def test_serving_on_a_mesh_is_item_19():
    """Serving on a mesh (item 19) runs: a 2x2 session on the CPU's
    virtual devices steps to the oracle's board, a CPU manager's default
    stays 1x1, and a mesh past the 8 virtual devices is refused with the
    reference's make_mesh message."""
    mgr = SessionManager(device="cpu")
    try:
        sid = mgr.create({"rows": 64, "cols": 64, "mesh": "2x2"})["id"]
        mgr.step(sid, 3)
        grid, gen, _ = mgr.snapshot_array(sid)
        assert gen == 3 and mgr.get(sid).engine.mesh.dims == (2, 2)
        np.testing.assert_array_equal(grid, evolve_np(
            init_tile_np(64, 64, 0), 3, LIFE, "periodic"))
        one = mgr.create({"rows": 64, "cols": 64})["id"]
        assert (mgr.get(one).engine.mi, mgr.get(one).engine.mj) == (1, 1)
        with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) needs 9 "
                           r"devices, have 8"):
            mgr.create({"rows": 96, "cols": 96, "mesh": "3x3"})
    finally:
        mgr.shutdown()


# -- the verifier's mesh half ----------------------------------------------

def _collective_findings(cell_id):
    with contextlib.redirect_stderr(io.StringIO()):
        rc = record_cell(cell_by_id(cell_id), "cpu")
    return rc, checks.check_collectives(rc)


def test_mesh_cells_record_their_exchanges_and_are_clean():
    rc, found = _collective_findings("packed_2x2_dead")
    assert found == []
    # two passes a step of depth 2, four ppermutes an exchange
    assert len(rc.collectives) == 2 * 2 * 4
    # shard (0, 0) of a dead 2x2 mesh: one word a row, a bottom ghost row
    assert {c.shape for c in rc.collectives} == {(1, 1), (33, 1)}
    assert all(len(c.pairs) == 1 for c in rc.collectives)
    rc, found = _collective_findings("ltl_r2_k2_1x2")
    assert found == [] and {min(c.shape) for c in rc.collectives} <= {1, 2, 4}


def test_seeded_non_bijective_exchange_detected(monkeypatch):
    real = halo.axis_pairs

    def doubled(n, periodic):
        fwd, bwd = real(n, periodic)
        return fwd + [(0, 1)], bwd

    monkeypatch.setattr(halo, "axis_pairs", doubled)
    _, found = _collective_findings("packed_1x2_periodic")
    msgs = [f.message for f in found]
    assert msgs and all(f.check == "ir-collective" for f in found)
    assert any("is not a bijection: duplicate source" in m for m in msgs)


def test_seeded_open_ring_detected(monkeypatch):
    real = halo.axis_pairs
    monkeypatch.setattr(halo, "axis_pairs",
                        lambda n, periodic: real(n, False))
    _, found = _collective_findings("packed_2x2_periodic")
    assert any("closes only 1 of 2 ring links" in f.message for f in found)


def test_seeded_wrong_slab_depth_detected(monkeypatch):
    """A stepper that ships two ghost word columns where one is the
    protocol: the slab is 2 deep where Life at comm_every 1 allows 1."""
    real = port_step.exchange_halo_rc

    def deeper(shards, rr, rc, *a, **kw):
        return real(shards, rr, rc + 1, *a, **kw)

    monkeypatch.setattr(port_step, "exchange_halo_rc", deeper)
    _, found = _collective_findings("packed_w128_1x2")
    assert any("has depth 2, expected one of [1]" in f.message
               for f in found), [f.message for f in found]


@pytest.mark.parametrize("shard", [(0, 0), (0, -1), (-1, -1)],
                         ids=["first", "last_column", "last"])
def test_seeded_write_into_an_entry_shard_detected(shard):
    """A mesh step that writes into one shard of the grid it was given
    (here a stitch of the result back into that shard) breaks the engine's
    contract of writing new shards; ``ir-donation`` flags it whichever
    shard it is."""
    from mpi_tpu_torch.analysis.ir.harness import record_engine
    from mpi_tpu_torch.backends.cuda import build_engine

    cell = cell_by_id("packed_2x2_dead")
    mesh = make_mesh(cell.mesh, devices=[torch.device("cpu")] * 4)
    with contextlib.redirect_stderr(io.StringIO()):
        engine = build_engine(cell.make_config(), device="cpu", mesh=mesh)
    real = engine._evolve
    i, j = shard

    def stitch_back(shards, steps):
        out = real(shards, steps)
        shards[i][j].copy_(out[i][j])
        return out

    rc = record_engine(cell, engine, evolve=stitch_back)
    found = checks.check_donation(rc)
    assert found and all(f.check == "ir-donation" for f in found)
    assert "writes into the step's entry grid" in found[0].message
    with contextlib.redirect_stderr(io.StringIO()):
        clean = record_cell(cell, "cpu")
    assert checks.check_donation(clean) == []
