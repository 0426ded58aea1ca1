"""Resume, refusals and failure across a process group of the port's CLI
(``--multihost``), beside the reference's ``tests/test_multihost.py``:
each rank reads only the snapshot regions of its own shards
(``golio.assemble_region``), the files of a written-then-resumed run equal
byte for byte the reference's single-process run of the same two steps,
a config the ranks cannot run is refused on every rank before any file is
written, and a rank that fails makes its group fail instead of hang."""

import os

import numpy as np
import pytest

from mpi_tpu_torch import golio
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.models.rules import LIFE, rule_from_name
from mpi_tpu_torch.utils.hashinit import init_tile_np
from torch_groups import assert_same_files, launch, reference, run_group

R2 = "R2,B10-13,S8-12"


def _written_then_resumed(tmp_path, base, n, write_mesh, resume_mesh, name):
    """Both steps by a group and by the reference, files held equal after
    each; returns the port's dir."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    base = list(base) + ["--save", "--seed", "5", "--quiet", "--name", name]
    resume = ["--resume", f"{name}@8"]
    run_group(base + ["--mesh", write_mesh], n, port)
    reference(base, write_mesh, name, ref)
    assert_same_files(ref, port)
    run_group(base + ["--mesh", resume_mesh] + resume, n, port)
    reference(base + resume, resume_mesh, name, ref)
    assert_same_files(ref, port)
    return port


@pytest.mark.parametrize("rows,cols,name", [
    (32, 32, "ckpt"),    # 16-cell shards: the padded packed engine with
                         # the seam band across the ranks
    (64, 256, "pck"),    # whole-word shards: the packed engine
])
def test_two_process_resume(tmp_path, rows, cols, name):
    port = _written_then_resumed(tmp_path, [str(rows), str(cols), "8", "8"],
                                 2, "2x2", "2x2", name)
    np.testing.assert_array_equal(
        golio.assemble(port, name, 16),
        evolve_np(init_tile_np(rows, cols, 5), 16, LIFE, "periodic"))


def test_uneven_ltl_resume(tmp_path):
    """Written on 1x4, resumed on 2x2: every rank's shards cut across the
    written tiles, so ``assemble_region`` stitches parts of several."""
    port = _written_then_resumed(
        tmp_path, ["64", "512", "8", "8", "--rule", R2], 2, "1x4", "2x2",
        "uneven")
    np.testing.assert_array_equal(
        golio.assemble(port, "uneven", 16),
        evolve_np(init_tile_np(64, 512, 5), 16, rule_from_name(R2),
                  "periodic"))
    assert golio.read_master(golio.master_path(port, "uneven"))[4] == 4


@pytest.mark.parametrize("argv,message", [
    (["64", "96", "4", "8", "--sparse", "32"], "sparse_tile requires a "
     "single-device mesh (got 1x2); shard OR activity-gate, not both yet"),
    (["64", "96", "4", "8", "--mesh", "1x3"], "mesh (1, 3) cannot be split "
     "over 2 processes (3 shards)"),
    (["64", "96", "4", "8", "--mesh", "8x4"], "mesh shape (8, 4) needs 32 "
     "devices, have 16"),
    # strict mode judges the world mesh: 2 ranks, one device each, 1x2
    (["64", "64", "4", "8", "--strict"], "strict mode: device count must be "
     "a perfect square mesh (effective mesh 1x2)"),
], ids=["sparse", "uneven-split", "too-many-shards", "strict"])
def test_group_refusals(tmp_path, argv, message):
    out = tmp_path / "out"
    results = launch(argv + ["--quiet"], 2, str(out))
    for rc, _, err in results:
        assert rc == 2 and message in err, err[-2000:]
    assert not out.exists()


def test_strict_passes_a_square_world_mesh(tmp_path):
    run_group(["64", "64", "4", "8", "--strict", "--mesh", "2x2",
               "--quiet"], 2, str(tmp_path))


def test_a_failed_rank_fails_its_group(tmp_path):
    """Rank 1 cannot find the snapshot it should resume (its out dir lacks
    it) and exits 2; rank 0 loads its regions, steps, and its first
    exchange fails on the closed group: no rank hangs."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    os.makedirs(b)
    base = ["64", "256", "8", "8", "--seed", "5", "--quiet", "--mesh", "2x2",
            "--name", "f"]
    run_group(base + ["--save"], 2, a)
    results = launch(base + ["--resume", "f@8"], 2, [a, b], timeout_s=60)
    assert results[1][0] == 2 and "cannot resume" in results[1][2]
    assert results[0][0] not in (0, 2), results[0][2][-2000:]
