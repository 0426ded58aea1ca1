"""The port's multi-process mesh (``--multihost``) beside the reference's
``tests/test_multihost.py``, scenario for scenario: real gloo groups of 2
and 4 processes of ``python -m mpi_tpu_torch.cli ... --device cpu``,
whose ``.gol`` files and master header must equal byte for byte the
reference's single-process ``--mesh`` run of the same config on its
virtual CPU devices (``torch_groups.reference``), and the serial oracle.
The resumes are in ``test_torch_multihost_resume.py``."""

import os

import numpy as np
import pytest

from mpi_tpu.parallel.mesh import choose_mesh_shape as jax_choose_mesh_shape
from mpi_tpu_torch import golio
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.models.rules import LIFE, rule_from_name
from mpi_tpu_torch.utils.hashinit import init_tile_np
from torch_groups import assert_same_files, reference, run_group

R2 = "R2,B10-13,S8-12"


def _oracle(rows, cols, steps, rule=LIFE):
    return evolve_np(init_tile_np(rows, cols, 5), steps, rule, "periodic")


def _both(tmp_path, argv, mesh, n, name, group_extra=()):
    """The group of ``n`` ranks on ``mesh`` and the reference on the same
    mesh, the same files; returns the port's dir and its ranks' stdout."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    base = list(argv) + ["--save", "--seed", "5"]
    outs = run_group(base + ["--mesh", mesh, *group_extra], n, port)
    reference(base, mesh, name, ref)
    assert_same_files(ref, port)
    return port, outs


def test_two_process_group_run(tmp_path):
    """32x32 on 2x2 over 2 ranks (the reference's 2 processes x 2
    devices): 16-cell shards are padded, so the seam band is gathered
    across the ranks; process 0 alone appends the CSV row, whose avg and
    sum columns come from both processes' durations."""
    port, _ = _both(tmp_path, ["32", "32", "8", "16", "mh", "1", "--quiet"],
                    "2x2", 2, "run-32x32-16-s5")
    name = "run-32x32-16-s5"   # named from the config, on every rank
    assert golio.read_master(golio.master_path(port, name)) == \
        (32, 32, 8, 16, 4)
    np.testing.assert_array_equal(golio.assemble(port, name, 16),
                                  _oracle(32, 32, 16))
    with open(os.path.join(port, "mh_compact.csv")) as f:
        lines = f.read().strip().split("\n")
    assert len(lines) == 2, "only process 0 may append a CSV row"
    row = [int(x) for x in lines[1].split(",")]
    assert len(row) == 12 and row[:3] == [32, 32, 4]
    for single, avg, total in (row[3:6], row[6:9], row[9:12]):
        assert total >= single > 0 and avg == total // 2


def test_default_mesh_is_one_device_a_rank(tmp_path):
    """Pinned divergence: without ``--mesh`` each rank takes one device,
    so 2 ranks run 1x2 (2 tile writers); the reference's 2 processes x 2
    virtual devices run its most-square mesh of all 4, 2x2."""
    out = str(tmp_path)
    logs = run_group(["32", "64", "4", "8", "--save", "--seed", "5"], 2, out)
    name = "run-32x64-8-s5"
    assert golio.read_master(golio.master_path(out, name))[4] == 2
    assert golio.iteration_tile_pids(out, name, 8) == [0, 1]
    np.testing.assert_array_equal(golio.assemble(out, name, 8),
                                  _oracle(32, 64, 8))
    assert jax_choose_mesh_shape(2 * 2) == (2, 2)
    for p, log in enumerate(logs):
        assert f"multihost: process {p}/2 on " in log
        assert "halo transport gloo" in log
        assert "population n/a (multihost)" in log


def test_two_process_packed_engine(tmp_path):
    # 256/2 = 128 cells a shard: whole words, the SWAR stepper (K1)
    port, _ = _both(tmp_path, ["64", "256", "16", "16", "--quiet"], "2x2",
                    2, "run-64x256-16-s5")
    np.testing.assert_array_equal(
        golio.assemble(port, "run-64x256-16-s5", 16), _oracle(64, 256, 16))


def test_two_process_ltl_engine(tmp_path):
    # radius 2 on whole-word shards: the bit-sliced stepper (K3)
    port, _ = _both(tmp_path, ["64", "256", "16", "16", "--rule", R2,
                               "--quiet"], "2x2", 2, "run-64x256-16-s5")
    np.testing.assert_array_equal(
        golio.assemble(port, "run-64x256-16-s5", 16),
        _oracle(64, 256, 16, rule_from_name(R2)))


def test_four_process_group(tmp_path):
    """4 ranks, one device each: the mesh is the most-square of 4, 2x2, as
    the reference's one device a process gives."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    argv = ["32", "32", "16", "16", "--save", "--seed", "5", "--quiet"]
    run_group(argv, 4, port)
    reference(argv, "2x2", "run-32x32-16-s5", ref)
    assert_same_files(ref, port)
    assert golio.read_master(golio.master_path(
        port, "run-32x32-16-s5"))[4] == 4


def test_comm_every_auto_agrees(tmp_path):
    """Every rank takes process 0's probed latency, so all resolve the
    same K (different K would post exchanges that never pair)."""
    _, outs = _both(tmp_path, ["64", "256", "16", "16", "--comm-every",
                               "auto"], "2x2", 2, "run-64x256-16-s5")
    lines = [[ln for ln in out.splitlines() if "comm policy auto" in ln]
             for out in outs]
    assert len(lines[0]) == 1 and lines[0] == lines[1]


def test_fused_interior(tmp_path):
    """The reference's fused Pallas interiors on 8192-cell shards: here
    K1's plain version steps each rank's wide shard windows."""
    _both(tmp_path, ["16", "16384", "4", "4", "--quiet"], "2x2", 2,
          "fusedmh", group_extra=["--name", "fusedmh"])


@pytest.mark.parametrize("extra", [
    ["--boundary", "dead", "--comm-every", "2", "--mesh", "1x2"],
    ["--overlap", "--comm-every", "2", "--mesh", "2x1"],
    ["--rule", "bosco", "--overlap", "--mesh", "2x4"],
], ids=["dead-k2-1x2", "overlap-2x1", "bosco-overlap-2x4"])
def test_group_meshes_equal_the_reference(tmp_path, extra):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    argv = ["64", "256", "4", "8", "--save", "--seed", "5", "--quiet"]
    run_group(argv + extra, 2, port)
    mesh = extra[extra.index("--mesh") + 1]
    rest = [a for a in extra if a not in ("--mesh", mesh)]
    reference(argv + rest, mesh, "run-64x256-8-s5", ref)
    assert_same_files(ref, port)


def test_profile_writes_one_trace_a_rank(tmp_path):
    traces = tmp_path / "traces"
    run_group(["64", "64", "0", "4", "--quiet", "--profile", str(traces)],
              2, str(tmp_path))
    names = sorted(os.listdir(traces))
    assert [n.split("-")[1] for n in names] == ["r0", "r1"], names
