"""The port's golio readers (``read_tile_header``,
``list_snapshot_iterations``, ``assemble``, ``assemble_region``) against
the reference's ``mpi_tpu.golio`` on files the port's CLI wrote: one tile
from ``--backend cuda --device cpu`` and a 2 x 2 tile mesh from
``--backend cpp-par --workers 4``, in ``.gol`` and ``.golp``; the whole
grid and regions drawn from a seed read equal by both packages."""

from __future__ import annotations

import os

import numpy as np
import pytest

from mpi_tpu import golio as ref_golio
from mpi_tpu_torch import golio
from mpi_tpu_torch.cli import main

RUNS = {"cuda": ["--device", "cpu"], "cpp-par": ["--workers", "4"]}


@pytest.fixture(scope="module", params=[(b, f) for b in RUNS
                                        for f in ("gol", "golp")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request, tmp_path_factory):
    backend, fmt = request.param
    out = str(tmp_path_factory.mktemp(f"{backend}-{fmt}"))
    assert main(["48", "40", "3", "9", "--backend", backend, *RUNS[backend],
                 "--save", "--snapshot-format", fmt, "--rule", "highlife",
                 "--name", "r", "--out-dir", out, "--quiet"]) == 0
    return out, backend, fmt


def test_iterations_and_headers_equal_the_references(run):
    out, backend, fmt = run
    its = golio.list_snapshot_iterations(out, "r")
    assert its == ref_golio.list_snapshot_iterations(out, "r") == \
        [0, 3, 6, 9]
    assert golio.list_snapshot_iterations(out, "other") == []
    pids = golio.iteration_tile_pids(out, "r", 9)
    assert pids == ref_golio.iteration_tile_pids(out, "r", 9)
    assert len(pids) == (4 if backend == "cpp-par" else 1)
    for pid in pids:
        path = golio.find_tile_path(out, "r", 9, pid)
        assert path.endswith("." + fmt)
        assert golio.read_tile_header(path) == \
            ref_golio.read_tile_header(path) == golio.read_tile(path)[1]


def test_whole_grids_equal_the_references(run):
    out, _, _ = run
    for it in golio.list_snapshot_iterations(out, "r"):
        grid = golio.assemble(out, "r", it)
        assert grid.shape == (48, 40) and grid.dtype == np.uint8
        assert np.array_equal(grid, ref_golio.assemble(out, "r", it))
        assert np.array_equal(grid, golio.load_snapshot(out, "r", it))


def test_regions_equal_the_references(run):
    out, _, _ = run
    rng = np.random.default_rng(17)
    full = golio.assemble(out, "r", 6)
    for _ in range(25):
        r0, r1 = sorted(rng.choice(49, size=2, replace=False))
        c0, c1 = sorted(rng.choice(41, size=2, replace=False))
        got = golio.assemble_region(out, "r", 6, r0, r1, c0, c1)
        assert np.array_equal(
            got, ref_golio.assemble_region(out, "r", 6, r0, r1, c0, c1))
        assert np.array_equal(got, full[r0:r1, c0:c1])


def test_a_missing_tile_is_refused_alike(run):
    out, backend, _ = run
    if backend != "cpp-par":
        assert golio.iteration_tile_pids(out, "r", 12) == []
        with pytest.raises(ValueError, match="no tile files") as e:
            golio.assemble(out, "r", 12)
        with pytest.raises(ValueError) as f:
            ref_golio.assemble(out, "r", 12)
        assert str(e.value) == str(f.value)
        return
    gone = golio.find_tile_path(out, "r", 3, 3)
    os.remove(gone)
    with pytest.raises(ValueError, match="cover only") as e:
        golio.assemble(out, "r", 3)
    with pytest.raises(ValueError) as f:
        ref_golio.assemble(out, "r", 3)
    assert str(e.value) == str(f.value)
    # a region clear of the missing tile still reads, from the others only
    assert np.array_equal(golio.assemble_region(out, "r", 3, 0, 24, 0, 20),
                          ref_golio.assemble_region(out, "r", 3, 0, 24, 0,
                                                    20))
