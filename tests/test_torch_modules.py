"""The port's own copies of the JAX-free reference modules (rules, segment
plans, timing reports, ``.gol`` I/O, the numpy oracle) against the
originals: same answers, same errors, same bytes."""

import filecmp
import os

import numpy as np
import pytest

from mpi_tpu import golio as jgolio
from mpi_tpu.backends import serial_np as jserial
from mpi_tpu.config import plan_segments as jplan_segments
from mpi_tpu.models import rules as jrules
from mpi_tpu.utils import timing as jtiming
from mpi_tpu.utils.segmenting import segment_depths as jsegment_depths
from mpi_tpu_torch import golio
from mpi_tpu_torch.backends import serial_np
from mpi_tpu_torch.config import plan_segments
from mpi_tpu_torch.models import rules
from mpi_tpu_torch.utils import timing
from mpi_tpu_torch.utils.hashinit import init_tile_np
from mpi_tpu_torch.utils.segmenting import segment_depths, segmented_evolve


@pytest.mark.parametrize("name", [
    "life", "HighLife", "seeds", "daynight", "bosco", "B3/S23", "B36/S23",
    "b3678/s34678", "B/S", "R5,B34-45,S33-57", "R2,B3+5-6,S2-4",
])
def test_rule_from_name_matches_reference(name):
    mine, ref = rules.rule_from_name(name), jrules.rule_from_name(name)
    assert (mine.name, mine.birth, mine.survive, mine.radius) == \
        (ref.name, ref.birth, ref.survive, ref.radius)
    assert str(mine) == str(ref)
    assert mine.max_count == ref.max_count
    assert mine.birth_intervals == ref.birth_intervals
    assert mine.survive_intervals == ref.survive_intervals
    for a, b in zip(mine.tables(), ref.tables()):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["nope", "R5,B1", "Rx,B1,S2", "B9/S2",
                                  "R8,B1,S1", "R0,B1,S1"])
def test_rule_errors_match_reference(name):
    with pytest.raises(ValueError) as ref:
        jrules.rule_from_name(name)
    with pytest.raises(ValueError) as mine:
        rules.rule_from_name(name)
    assert str(mine.value) == str(ref.value)


@pytest.mark.parametrize("steps,every", [(0, 0), (10, 0), (10, 3), (10, 10),
                                         (10, 20), (17, 5)])
def test_segment_plans_match_reference(steps, every):
    segs = plan_segments(steps, every)
    assert segs == jplan_segments(steps, every)
    for K in (1, 4, 16):
        assert segment_depths(segs, K) == jsegment_depths(segs, K)


def test_segmented_evolve_ping_pongs():
    calls = []

    def local(src, k, dst):
        calls.append((src, k, dst))
        return dst

    grid, spare = segmented_evolve(local, 4)("a", 10, "b")
    assert calls == [("a", 4, "b"), ("b", 4, "a"), ("a", 2, "b")]
    assert (grid, spare) == ("b", "a")


def test_timing_reports_match_reference(tmp_path):
    t = timing.PhaseTimer(t_begin=1.0, t_setup_done=1.25, t_end=3.5)
    r = jtiming.PhaseTimer(t_begin=1.0, t_setup_done=1.25, t_end=3.5)
    for first in (True, False):
        timing.write_reports("x", t, 64, 96, 1, first=first,
                             out_dir=str(tmp_path))
        jtiming.write_reports("y", r, 64, 96, 1, first=first,
                              out_dir=str(tmp_path))
    for suffix in ("_detailed.out", "_compact.csv"):
        assert filecmp.cmp(tmp_path / f"x{suffix}", tmp_path / f"y{suffix}",
                           shallow=False)
    assert t.cells_per_sec(64, 96, 10) == r.cells_per_sec(64, 96, 10)


@pytest.mark.parametrize("fmt", ["gol", "golp"])
def test_golio_files_match_reference(tmp_path, fmt):
    grid = np.random.default_rng(4).integers(0, 2, (12, 21), dtype=np.uint8)
    mine, ref = tmp_path / "m", tmp_path / "r"
    mine.mkdir()
    ref.mkdir()
    tiles = [(grid[:6], 0, 0), (grid[6:], 6, 0)]
    for mod, d in ((golio, mine), (jgolio, ref)):
        mod.write_master(str(d), "n", 12, 21, 5, 10, 2)
        mod.write_snapshot_tiles(str(d), "n", 5, tiles, fmt=fmt)
    names = sorted(os.listdir(ref))
    assert names == sorted(os.listdir(mine))
    assert filecmp.cmpfiles(ref, mine, names, shallow=False)[1] == []
    np.testing.assert_array_equal(golio.load_snapshot(str(ref), "n", 5), grid)
    assert golio.read_master(golio.master_path(str(ref), "n")) == \
        (12, 21, 5, 10, 2)
    # a rewrite with fewer writers leaves no stale tile behind
    golio.write_snapshot_tiles(str(mine), "n", 5, [(grid, 0, 0)], fmt=fmt)
    assert golio.iteration_tile_pids(str(mine), "n", 5) == [0]
    np.testing.assert_array_equal(golio.load_snapshot(str(mine), "n", 5), grid)


def test_golio_refuses_partial_snapshots(tmp_path):
    d = str(tmp_path)
    golio.write_master(d, "n", 4, 4, 1, 1, 1)
    golio.write_tile(d, "n", 1, 0, np.ones((2, 4), np.uint8), 0, 0)
    with pytest.raises(ValueError, match="cover only"):
        golio.load_snapshot(d, "n", 1)
    with pytest.raises(ValueError, match="no tile files"):
        golio.load_snapshot(d, "n", 2)


@pytest.mark.parametrize("rule", ["life", "daynight", "bosco"])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_serial_oracle_matches_reference(rule, boundary):
    g = init_tile_np(20, 23, 6)
    np.testing.assert_array_equal(
        serial_np.evolve_np(g, 3, rules.rule_from_name(rule), boundary),
        jserial.evolve_np(g, 3, jrules.rule_from_name(rule), boundary))
