"""Periodic wrap-seam stitching in the port (``mpi_tpu_torch/parallel/
seam.py``) against the JAX package's ``mpi_tpu.parallel.seam``, on the
CPU: the band's geometry, extraction, stepping and stitching piece by
piece, K2's band (its plain version here) against ``evolve_band`` on the
middle columns, and whole seam runs against ``run_tpu`` on a 1x1 mesh and
the serial oracle, with snapshots and resume."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tpu.backends.tpu import run_tpu
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.ops.bitlife import pack_np as jax_pack_np
from mpi_tpu.parallel import seam as jax_seam
from mpi_tpu_torch import golio, interop
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import BOSCO, LIFE, rule_from_name
from mpi_tpu_torch.ops.bitlife import unpack
from mpi_tpu_torch.parallel import seam
from mpi_tpu_torch.utils.hashinit import init_tile_np

R2 = rule_from_name("R2,B10-13,S8-12")


def _padded(grid, cols_padded):
    rows, cols = grid.shape
    gp = np.zeros((rows, cols_padded), dtype=np.uint8)
    gp[:, :cols] = grid
    words = jax_pack_np(gp)
    return interop.grid_from_numpy(words, "cpu"), jnp.asarray(words), gp


@pytest.mark.parametrize("C,d", [(100, 3), (100, 16), (40, 10), (70, 8),
                                 (33, 8), (200, 31)])
def test_extract_and_stitch_match_the_reference(C, d):
    g = init_tile_np(16, C, seed=3)
    t, j, gp = _padded(g, -(-C // 32) * 32)
    band = seam.extract_band(t, C, d)
    assert band.shape == (16, 4 * d) and band.dtype == torch.uint8
    np.testing.assert_array_equal(band.numpy(),
                                  np.asarray(jax_seam.extract_band(j, C, d)))
    np.testing.assert_array_equal(
        band.numpy(), np.concatenate([g[:, C - 2 * d:], g[:, :2 * d]], 1))
    # stitching the unevolved band back is the identity
    assert seam.stitch_band(t.clone(), band, C, d).equal(t)
    # any band: the same words as the reference's stitch
    other = torch.from_numpy(init_tile_np(16, 4 * d, seed=8))
    got = seam.stitch_band(t.clone(), other, C, d)
    want = jax_seam.stitch_band(j, jnp.asarray(other.numpy()), C, d)
    np.testing.assert_array_equal(interop.grid_to_numpy(got),
                                  np.asarray(want))


def test_stitch_overwrites_only_the_seam_columns_and_takes_boards():
    C, d = 100, 2
    boards = [init_tile_np(8, C, seed=s) for s in (5, 6)]
    t = torch.stack([_padded(b, 128)[0] for b in boards])
    ones = torch.ones((2, 8, 4 * d), dtype=torch.uint8)
    st = unpack(seam.stitch_band(t.clone(), ones, C, d).reshape(16, 4))
    st = st.reshape(2, 8, 128).numpy()
    for b, g in zip(st, boards):
        assert (b[:, :d] == 1).all() and (b[:, C - d:C] == 1).all()
        np.testing.assert_array_equal(b[:, d:C - d], g[:, d:C - d])
        assert (b[:, C:] == 0).all()  # pad untouched
    band = seam.extract_band(t, C, d)
    assert band.shape == (2, 8, 4 * d)
    assert band[1].equal(seam.extract_band(t[1], C, d))


def test_band_geometry_matches_the_reference():
    for C, d in [(30, 8), (1000, 32), (64, 16), (63, 16), (66, 16),
                 (4, 1), (3, 1), (100, 0)]:
        assert seam.seam_serves(C, d) == jax_seam.seam_serves(C, d)
    with pytest.raises(ValueError, match="width >= "):
        seam.band_cols(30, 8)
    with pytest.raises(ValueError, match="1..31"):
        seam.band_cols(1000, 32)
    assert seam.band_cols(64, 16) == 64


@pytest.mark.parametrize("rule,k", [(LIFE, 1), (LIFE, 3), (LIFE, 16),
                                    (R2, 2), (R2, 4), (BOSCO, 1)])
def test_evolve_band_matches_the_reference_and_k2_its_middle(rule, k):
    d = k * rule.radius
    C = 4 * d + 7
    g = init_tile_np(300, C, seed=9)  # several chunks of K2's band
    strip = np.concatenate([g[:, C - 2 * d:], g[:, :2 * d]], axis=1)
    got = seam.evolve_band(torch.from_numpy(strip), rule, k)
    want = jax_seam.evolve_band(jnp.asarray(strip),
                                jax_rule_from_name(rule.name), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = evolve_np(g, k, rule, "periodic")
    mid = np.concatenate([ref[:, C - d:], ref[:, :d]], axis=1)
    np.testing.assert_array_equal(got.numpy()[:, d:3 * d], mid)
    # K2's band (its plain version on the CPU; the kernel on the card in
    # chip_smoke.py): the same middle, for a batch of boards too
    both = torch.from_numpy(np.stack([strip, strip[::-1].copy()]))
    k2 = seam.step_band(both, rule, k)[..., d:3 * d]
    ev = seam.evolve_band(both, rule, k)[..., d:3 * d]
    assert k2.equal(ev) and k2[0].equal(got[:, d:3 * d])


def _jax_cfg(cfg):
    return JaxConfig(rows=cfg.rows, cols=cfg.cols, steps=cfg.steps,
                     seed=cfg.seed, snapshot_every=cfg.snapshot_every,
                     rule=jax_rule_from_name(cfg.rule.name),
                     boundary="periodic", comm_every=cfg.comm_every,
                     backend="tpu", mesh_shape=(1, 1))


@pytest.mark.parametrize("cols,K,rule", [
    (100, 1, LIFE), (100, 2, LIFE), (200, 3, LIFE), (1000, 1, LIFE),
    (66, 4, LIFE), (40, 1, LIFE), (100, 2, R2), (100, 1, BOSCO),
    (66, 16, LIFE),                    # near the 4d floor: 66 >= 64
])
def test_seam_runs_match_run_tpu_and_the_oracle(cols, K, rule):
    steps = 3 * K + 1 if K < 16 else 17  # whole passes and a remainder
    cfg = GolConfig(rows=32, cols=cols, steps=steps, seed=7, comm_every=K,
                    rule=rule)
    eng = port.build_engine(cfg, device="cpu")
    assert eng.seam and eng.pad_bits > 0
    got = port.run_cuda(cfg, device="cpu")
    np.testing.assert_array_equal(got, run_tpu(_jax_cfg(cfg)))
    np.testing.assert_array_equal(
        got, evolve_np(init_tile_np(32, cols, 7), steps, rule, "periodic"))


def test_seam_snapshots_with_mixed_depths_crop_to_the_real_width():
    # segments [3, 3, 2] mix pass depths {3, 2} under the seam stepper
    cfg = GolConfig(rows=32, cols=100, steps=8, seed=31, comm_every=3,
                    snapshot_every=3)
    seen = []

    def cb(iteration, tiles):
        seen.append((iteration, tiles[0][1]))

    port.run_cuda(cfg, snapshot_cb=cb, device="cpu")
    assert [i for i, _ in seen] == [0, 3, 6, 8]
    for it, tile in seen:
        assert tile.shape == (32, 100)
        np.testing.assert_array_equal(
            tile, evolve_np(init_tile_np(32, 100, 31), it, LIFE, "periodic"))


def test_seam_resume_roundtrip(tmp_path):
    full = port.run_cuda(GolConfig(rows=32, cols=100, steps=8, seed=17),
                         device="cpu")
    half = port.run_cuda(GolConfig(rows=32, cols=100, steps=4, seed=17),
                         device="cpu")
    golio.write_master(str(tmp_path), "h", 32, 100, 4, 4, 1)
    golio.write_snapshot_tiles(str(tmp_path), "h", 4, [(half, 0, 0)])
    loaded = golio.load_snapshot(str(tmp_path), "h", 4)
    resumed = port.run_cuda(GolConfig(rows=32, cols=100, steps=4, seed=17),
                            initial=loaded, start_iteration=4, device="cpu")
    np.testing.assert_array_equal(resumed, full)


def test_seam_declined_stays_dense_with_the_note(capsys):
    cfg = GolConfig(rows=64, cols=36, steps=4, seed=3, comm_every=12)
    got = port.run_cuda(cfg, device="cpu")
    np.testing.assert_array_equal(
        got, evolve_np(init_tile_np(64, 36, 3), 4, LIFE, "periodic"))
    assert "seam stitching needs" in capsys.readouterr().err
    assert port.select_engine(cfg) == "dense"
