"""Pad-to-32 routing in the port against the JAX package, on the CPU: the
pad plan, the padded K1 and K3 passes (their plain versions, with
``col_limit``) against the reference's padded 1x1-mesh steppers, whole
padded runs against ``run_tpu`` and the serial oracle, the routing notes
word for word, and the CLI's ``.gol`` files against the reference CLI's."""

import filecmp
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tpu.backends.serial_np import evolve_np as jax_evolve_np
from mpi_tpu.backends.tpu import build_engine as jax_build_engine
from mpi_tpu.backends.tpu import plan_pad_width as jax_plan_pad_width
from mpi_tpu.backends.tpu import run_tpu
from mpi_tpu.cli import main as jax_main
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.ops.bitlife import unpack_np
from mpi_tpu.parallel.mesh import make_mesh
from mpi_tpu.parallel.step import (
    make_sharded_bit_stepper, make_sharded_ltl_stepper, sharded_bit_init,
)
from mpi_tpu_torch import interop
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import LIFE, rule_from_name
from mpi_tpu_torch.ops.cuda_bitlife import bit_step_plain, cuda_bit_step
from mpi_tpu_torch.ops.cuda_bitltl import cuda_ltl_step, ltl_step_plain
from mpi_tpu_torch.utils.hashinit import init_tile_np

R2 = rule_from_name("R2,B10-13,S8-12")
BOSCO = rule_from_name("bosco")


def _jax_cfg(cfg: GolConfig, **kw) -> JaxConfig:
    return JaxConfig(rows=cfg.rows, cols=cfg.cols, steps=cfg.steps,
                     snapshot_every=cfg.snapshot_every, seed=cfg.seed,
                     rule=jax_rule_from_name(cfg.rule.name),
                     boundary=cfg.boundary, comm_every=cfg.comm_every,
                     backend="tpu", mesh_shape=(1, 1), **kw)


@pytest.mark.parametrize("cols,boundary,comm,rule", [
    (100, "dead", 1, "life"), (256, "dead", 1, "life"),
    (100, "periodic", 1, "life"), (36, "periodic", 12, "life"),
    (4000, "dead", 1, "life"), (3990, "dead", 1, "life"),
    (3990, "dead", 4, "life"), (1000, "dead", 1, "life"),
    (66, "periodic", 16, "life"), (63, "periodic", 16, "life"),
    (40, "periodic", 2, "R2,B10-13,S8-12"), (36, "periodic", 8, "R2,B10-13,S8-12"),
    (18, "periodic", 1, "bosco"), (20, "periodic", 1, "bosco"),
    (50, "dead", 3, "bosco"),
])
def test_plan_pad_width_matches_the_reference_without_the_lane_stretch(
        cols, boundary, comm, rule):
    cfg = GolConfig(rows=64, cols=cols, steps=1, boundary=boundary,
                    comm_every=comm, rule=rule_from_name(rule))
    want = jax_plan_pad_width(_jax_cfg(cfg), 1, fused_capable=False)
    assert port.plan_pad_width(cfg) == want
    cp, pad = want
    assert cp % 32 == 0 or pad == 0


def _padded_grid(rows, cols, seed):
    cp = -(-cols // 32) * 32
    mesh = make_mesh((1, 1))
    return cp, sharded_bit_init(mesh, rows, cp, seed, col_limit=cols)


@pytest.mark.parametrize("boundary", ["dead", "periodic"])
@pytest.mark.parametrize("cols,K", [
    (40, 1), (40, 3), (66, 3), (66, 4), (100, 2), (33, 16), (95, 8),
])
def test_padded_k1_plain_matches_the_reference_padded_stepper(
        boundary, cols, K):
    # the ghost word overlaps the pad at every depth here (one or a few
    # words a row).  On a periodic grid both wrap through the killed pad,
    # but the reference's left ghost word (word NW-1's copy) keeps its pad
    # bits during a pass's in-tile generations, so its base pass agrees
    # only outside the seam columns, which the seam band rewrites
    # (tests/test_torch_seam.py holds the stitched runs to the oracle)
    rows = 24
    cp, x = _padded_grid(rows, cols, seed=17)
    ref = make_sharded_bit_stepper(
        make_mesh((1, 1)), jax_rule_from_name("life"), boundary,
        gens_per_exchange=K, pad_bits=cp - cols,
        seam_pad=boundary == "periodic")
    g = interop.grid_from_numpy(np.asarray(x), "cpu")  # ref donates x
    want = np.asarray(ref(x, K))
    g = cuda_bit_step(g, LIFE, boundary, gens=K, col_limit=cols)
    got = interop.grid_to_numpy(g)
    if boundary == "periodic":
        keep = np.r_[K:cols - K, cols:cp]
        np.testing.assert_array_equal(unpack_np(got)[:, keep],
                                      unpack_np(want)[:, keep])
        return
    np.testing.assert_array_equal(got, want)
    want = np.asarray(ref(ref(jnp.asarray(want), K), 1))
    for k in (K, 1):
        g = cuda_bit_step(g, LIFE, boundary, gens=k, col_limit=cols)
    np.testing.assert_array_equal(interop.grid_to_numpy(g), want)
    if boundary == "dead":  # the pad plan's own semantics: the true grid
        cells = jax_evolve_np(init_tile_np(rows, cols, 17), 2 * K + 1,
                              jax_rule_from_name("life"), "dead")
        np.testing.assert_array_equal(
            port.Engine(GolConfig(rows=rows, cols=cols, steps=0),
                        port.resolve_device("cpu"), "bit", cols_eff=cp,
                        pad_bits=cp - cols).fetch(g), cells)


@pytest.mark.parametrize("boundary", ["dead", "periodic"])
@pytest.mark.parametrize("cols,K,rule", [
    (40, 1, R2), (72, 2, R2), (66, 4, R2), (100, 1, BOSCO),
])
def test_padded_k3_plain_matches_the_reference_padded_stepper(
        boundary, cols, K, rule):
    rows = 24
    cp, x = _padded_grid(rows, cols, seed=9)
    ref = make_sharded_ltl_stepper(
        make_mesh((1, 1)), jax_rule_from_name(rule.name), boundary,
        gens_per_exchange=K, pad_bits=cp - cols,
        seam_pad=boundary == "periodic")
    g = interop.grid_from_numpy(np.asarray(x), "cpu")  # ref donates x
    want = np.asarray(ref(x, K + 1))
    g = cuda_ltl_step(g, rule, boundary, gens=K, col_limit=cols)
    g = ltl_step_plain(g, rule, boundary, gens=1, col_limit=cols)
    np.testing.assert_array_equal(interop.grid_to_numpy(g), want)


def test_col_limit_is_checked_and_kills_only_the_pad():
    g = torch.full((3, 2), -1, dtype=torch.int32)
    out = bit_step_plain(g, rule_from_name("B1/S012345678"), "dead", 1,
                         col_limit=40)
    assert (out[:, 1] & ~0xFF).eq(0).all()
    assert bit_step_plain(g, LIFE, "dead", 1, col_limit=64).equal(
        bit_step_plain(g, LIFE, "dead", 1))
    for bad in (32, 65, 0):
        with pytest.raises(ValueError, match="col_limit"):
            bit_step_plain(g, LIFE, "dead", 1, col_limit=bad)


@pytest.mark.parametrize("cols,K,rule,boundary", [
    (40, 1, LIFE, "dead"), (72, 3, LIFE, "dead"), (100, 3, LIFE, "dead"),
    (66, 4, LIFE, "dead"), (40, 2, R2, "dead"), (66, 3, R2, "dead"),
    (100, 3, LIFE, "periodic"), (70, 4, R2, "periodic"),
    (100, 1, BOSCO, "periodic"),
])
def test_padded_run_cuda_matches_run_tpu_and_the_oracle(cols, K, rule,
                                                        boundary):
    cfg = GolConfig(rows=32, cols=cols, steps=3 * K + 1, seed=7,
                    comm_every=K, rule=rule, boundary=boundary)
    eng = port.build_engine(cfg, device="cpu")
    assert eng.pad_bits == eng.cols_eff - cols > 0
    assert eng.col_limit == cols and eng.seam == (boundary == "periodic")
    assert eng.kind == ("bit" if rule.radius == 1 else "ltl")
    got = port.run_cuda(cfg, device="cpu")
    np.testing.assert_array_equal(got, run_tpu(_jax_cfg(cfg)))
    np.testing.assert_array_equal(
        got, evolve_np(init_tile_np(32, cols, 7), 3 * K + 1, rule, boundary))


def test_padded_engine_inits_the_real_columns_and_crops():
    cfg = GolConfig(rows=16, cols=50, steps=0, seed=3, boundary="dead")
    eng = port.build_engine(cfg, device="cpu")
    assert (eng.cols_eff, eng.pad_bits, eng.col_limit) == (64, 14, 50)
    g = eng.init_grid()
    assert g.shape == (16, 2)
    assert int(((g[:, 1] >> 18) != 0).sum()) == 0  # the pad starts dead
    cells = init_tile_np(16, 50, 3)
    np.testing.assert_array_equal(eng.fetch(g), cells)
    assert eng.tiles(g)[0][1].shape == (16, 50)
    t = eng.init_grid(initial=cells)
    assert t.equal(g)
    g = eng.step(g, 5)
    want = evolve_np(cells, 5, LIFE, "dead")
    np.testing.assert_array_equal(eng.fetch(g), want)
    assert eng.population(g) == int(want.sum())


@pytest.mark.parametrize("kw", [
    dict(cols=36, comm_every=12),                      # radius 1, d 12
    dict(cols=36, comm_every=8, rule="R2,B10-13,S8-12"),
    dict(cols=18, rule="bosco"),
    dict(cols=100), dict(cols=100, boundary="dead"),
])
def test_routing_notes_match_the_reference_word_for_word(kw, capsys):
    kw = dict(kw)
    rule = rule_from_name(kw.pop("rule", "life"))
    cfg = GolConfig(rows=64, steps=1, rule=rule, **kw)
    ref = jax_build_engine(_jax_cfg(cfg))
    capsys.readouterr()
    eng = port.build_engine(cfg, device="cpu")
    assert eng.notes == ref.notes
    assert capsys.readouterr().err == "".join(f"note: {n}\n"
                                              for n in ref.notes)
    assert bool(eng.notes) == (eng.kind == "dense")


def _gol_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".gol"))


@pytest.mark.parametrize("boundary,rule,comm,cols", [
    ("dead", "life", "4", "50"), ("periodic", "life", "3", "70"),
    ("dead", "R2,B10-13,S8-12", "2", "40"), ("periodic", "bosco", "1", "60"),
])
def test_cli_padded_gol_files_match_reference_serial_and_resume(
        tmp_path, boundary, rule, comm, cols):
    common = ["40", cols, "5", "12", "--save", "--seed", "3",
              "--boundary", boundary, "--rule", rule, "--quiet"]
    ref, mine = tmp_path / "ref", tmp_path / "port"
    assert jax_main(common + ["--name", "n", "--backend", "serial",
                              "--out-dir", str(ref)]) == 0
    assert port_main(common + ["--name", "n", "--device", "cpu",
                               "--comm-every", comm,
                               "--out-dir", str(mine)]) == 0
    names = _gol_files(ref)
    assert names == _gol_files(mine) and len(names) == 5
    _, mismatch, errors = filecmp.cmpfiles(ref, mine, names, shallow=False)
    assert mismatch == [] and errors == []
    # resume from the 5th generation: the rest equals the straight run
    assert port_main(["40", cols, "5", "7", "--save", "--boundary",
                      boundary, "--rule", rule, "--quiet", "--device", "cpu",
                      "--comm-every", comm, "--out-dir", str(mine),
                      "--name", "b", "--resume", "n@5"]) == 0
    for it in (10, 12):
        assert filecmp.cmp(mine / f"n_{it}_0.gol", mine / f"b_{it}_0.gol",
                           shallow=False)
