"""The process group's pieces without the CLI (``parallel/dist.py``,
``parallel/mesh.py:world_mesh``, ``utils/timing.py``): the timing reports
with a gathered table byte for byte beside the reference's, the shards'
owners in the reference's device order, the refusals of ``--multihost``
message for message where the reference has one, and a real 2-rank gloo
halo exchange whose every ghost block equals the single-process
``exchange_halo_rc`` on the same shards."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mpi_tpu.cli import main as jax_main
from mpi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_tpu.utils.net import free_port
from mpi_tpu.utils.timing import PhaseTimer as JaxTimer
from mpi_tpu.utils.timing import write_reports as jax_write_reports
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import ConfigError, validate_mesh
from mpi_tpu_torch.parallel import dist
from mpi_tpu_torch.parallel.halo import exchange_halo_rc
from mpi_tpu_torch.parallel.mesh import make_mesh, world_mesh
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.utils.hashinit import init_tile_np
from mpi_tpu_torch.utils.timing import (
    PhaseTimer, gather_process_durations, write_reports,
)
from torch_groups import assert_same_files, reference, run_group

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- timing ----------------------------------------------------------------

@pytest.mark.parametrize("table,extra", [
    (None, None),
    ([[5_000_000, 4_000_000, 1_000_000], [5_200_001, 4_100_000, 1_100_001]],
     None),
    ([[9, 7, 2], [10, 8, 2], [11, 9, 2], [13, 10, 3]],
     {"cells/s/device": 1.5e9, "efficiency": 0.875}),
], ids=["wall", "two-processes", "four-processes-extra"])
def test_write_reports_equal_the_reference(tmp_path, table, extra):
    times = dict(t_begin=10.0, t_setup_done=11.25, t_end=14.5)
    j, p = tmp_path / "j", tmp_path / "p"
    j.mkdir()
    p.mkdir()
    for first in (True, False):
        jax_write_reports("t", JaxTimer(**times), 64, 128, 4, first=first,
                          out_dir=str(j), all_durations=table, extra=extra)
        write_reports("t", PhaseTimer(**times), 64, 128, 4, first=first,
                      out_dir=str(p), all_durations=table, extra=extra)
    for f in ("t_compact.csv", "t_detailed.out"):
        assert (j / f).read_bytes() == (p / f).read_bytes(), f


def test_gather_process_durations_is_none_outside_a_group():
    assert not dist.is_initialized()
    assert dist.process_count() == 1 and dist.process_index() == 0
    assert gather_process_durations(PhaseTimer()) is None


# -- the world mesh --------------------------------------------------------

@pytest.mark.parametrize("shape,processes", [
    ((2, 2), 2), ((1, 4), 2), ((2, 4), 2), ((2, 4), 4), ((4, 2), 2),
    ((2, 2), 4), ((1, 2), 2), ((8, 1), 4), ((2, 4), 8),
])
def test_shard_owners_follow_the_reference_device_order(shape, processes):
    """The reference's multi-process ``jax.devices()`` lists process 0's
    devices first and its CPU mesh reshapes them row-major: rank p owns the
    p-th row-major block of shards."""
    n = shape[0] * shape[1]
    per = n // processes
    ref = jax_make_mesh(shape, devices=jax.devices()[:n])
    want = tuple(tuple(d.id // per for d in row) for row in ref.devices)
    for rank in range(processes):
        mesh = world_mesh(shape, processes, rank,
                          [torch.device("cpu")] * processes)
        assert mesh.owners == want
        assert [divmod(k, shape[1]) for k in range(rank * per,
                                                   (rank + 1) * per)] \
            == mesh.local_shards()
        assert mesh.processes == processes and mesh.multiprocess


def test_world_mesh_on_the_card_takes_one_card_a_rank():
    cards = [torch.device("cuda", 0)] * 4   # 4 ranks sharing one card
    mesh = world_mesh((2, 2), 4, 3, cards)
    assert mesh.local_shards() == [(1, 1)] and mesh.owner(0, 1) == 1
    with pytest.raises(ValueError,
                       match=r"mesh shape \(1, 2\) needs 2 devices, have 4"):
        world_mesh((1, 2), 4, 0, cards)


def test_world_mesh_refusals_on_the_cpu():
    cpu = [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="cannot be split over 2 processes"):
        world_mesh((1, 3), 2, 0, cpu)
    with pytest.raises(ValueError, match="needs 18 devices, have 16"):
        world_mesh((2, 9), 2, 0, cpu)
    # one process: every shard local, as a single-process mesh's
    mesh = make_mesh((2, 2), platform="cpu")
    assert mesh.owners is None and not mesh.multiprocess
    assert mesh.local_shards() == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_validate_mesh_learns_the_world_size():
    validate_mesh(64, 64, (2, 2), 1, processes=4)
    validate_mesh(64, 64, (2, 2), 1, processes=2)
    with pytest.raises(ConfigError, match=r"mesh \(2, 2\) cannot be split "
                       r"over 3 processes \(4 shards\)"):
        validate_mesh(64, 64, (2, 2), 1, processes=3)


# -- the CLI's refusals before a group starts ------------------------------

@pytest.mark.parametrize("backend", ["serial", "cpp", "cpp-par"])
def test_multihost_refused_for_the_host_backends_like_the_reference(
        tmp_path, capsys, backend):
    args = ["32", "32", "8", "4", "--backend", backend, "--multihost",
            "--quiet"]
    assert jax_main(args + ["--out-dir", str(tmp_path / "j")]) == 2
    theirs = capsys.readouterr().err
    assert port_main(args + ["--out-dir", str(tmp_path / "p")]) == 2
    ours = capsys.readouterr().err
    assert ours == theirs.replace("the tpu backend", "the cuda backend")
    assert f"got backend={backend!r}" in ours
    assert not (tmp_path / "p").exists()


@pytest.mark.parametrize("extra,message", [
    (["--coordinator", "127.0.0.1:1"], "--coordinator needs "
     "--num-processes and --process-id"),
    (["--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "2"], "--process-id 2 is outside the group of 2"),
    (["--num-processes", "2", "--process-id", "0"],
     "--num-processes and --process-id go with --coordinator"),
    ([], "--multihost without --coordinator reads the group from the "
     "environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK not set"),
], ids=["no-size", "rank-out-of-range", "no-coordinator", "no-env"])
def test_multihost_refuses_a_group_it_cannot_join(tmp_path, capsys,
                                                  monkeypatch, extra,
                                                  message):
    for key in dist.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    assert port_main(["32", "32", "8", "4", "--device", "cpu",
                      "--multihost", "--quiet", "--out-dir",
                      str(tmp_path / "p")] + extra) == 2
    assert message in capsys.readouterr().err
    assert not dist.is_initialized() and not (tmp_path / "p").exists()


# -- a real 2-rank halo exchange -------------------------------------------

# (mesh, boundary, ghost rows, ghost cols, drop_dead, width_multiple, dtype)
HALO_CASES = [
    (shape, boundary, rr, rc, drop, wm, dtype)
    for shape in ((1, 2), (2, 1), (2, 2))
    for boundary in ("periodic", "dead")
    for rr, rc, drop, wm, dtype in ((2, 2, False, 1, "uint8"),
                                    (3, 1, True, 16, "int32"))
]
HALO_GRID = (24, 48)

HALO_WORKER = """
import json, sys
import numpy as np, torch
from mpi_tpu_torch.parallel import dist
from mpi_tpu_torch.parallel.halo import exchange_halo_rc
from mpi_tpu_torch.parallel.mesh import make_mesh
coordinator, rank, out, cases, grid = sys.argv[1:6]
dist.initialize(coordinator, 2, int(rank), device="cpu")
try:
    got = {}
    for k, (shape, boundary, rr, rc, drop, wm, dtype) in enumerate(
            json.loads(cases)):
        mesh = make_mesh(tuple(shape), platform="cpu")
        g = np.random.default_rng(k).integers(0, 100, json.loads(grid))
        h, w = g.shape[0] // shape[0], g.shape[1] // shape[1]
        shards = [[torch.from_numpy(g[i*h:(i+1)*h, j*w:(j+1)*w].astype(dtype))
                   if mesh.is_local(i, j) else None
                   for j in range(shape[1])] for i in range(shape[0])]
        ext = exchange_halo_rc(shards, rr, rc, boundary, drop_dead=drop,
                               width_multiple=wm, mesh=mesh)
        for i, j in mesh.local_shards():
            got[f"{k}/{i}/{j}"] = ext[i][j].numpy()
    np.savez(out, **got)
finally:
    dist.shutdown()
"""


@pytest.fixture(scope="module")
def halo_ranks(tmp_path_factory):
    """Both ranks' extended tiles of every case, by "case/i/j"."""
    d = tmp_path_factory.mktemp("halo")
    port = free_port("127.0.0.1")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", HALO_WORKER, f"127.0.0.1:{port}", str(r),
         str(d / f"r{r}.npz"), json.dumps(HALO_CASES),
         json.dumps(HALO_GRID)], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=120)[1] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
    out = {}
    for r in range(2):
        with np.load(d / f"r{r}.npz") as z:
            out.update({key: z[key] for key in z.files})
    return out


@pytest.mark.parametrize("k", range(len(HALO_CASES)), ids=[
    f"{s[0]}x{s[1]}-{b}-{rr}x{rc}{'-drop' if drop else ''}-{dt}"
    for s, b, rr, rc, drop, _, dt in HALO_CASES])
def test_two_rank_exchange_equals_one_process(halo_ranks, k):
    shape, boundary, rr, rc, drop, wm, dtype = HALO_CASES[k]
    g = np.random.default_rng(k).integers(0, 100, HALO_GRID)
    h, w = g.shape[0] // shape[0], g.shape[1] // shape[1]
    shards = [[torch.from_numpy(g[i * h:(i + 1) * h,
                                  j * w:(j + 1) * w].astype(dtype))
               for j in range(shape[1])] for i in range(shape[0])]
    want = exchange_halo_rc(shards, rr, rc, boundary, drop_dead=drop,
                            width_multiple=wm)
    for i in range(shape[0]):
        for j in range(shape[1]):
            np.testing.assert_array_equal(halo_ranks[f"{k}/{i}/{j}"],
                                          want[i][j].numpy())


# -- the seam band past K2's depth, across a 2-rank group ------------------

@pytest.mark.parametrize("argv", [
    ["39", "90", "4", "11", "--rule", "bosco", "--comm-every", "4",
     "--seed", "47"],
    ["40", "140", "4", "11", "--rule", "R2,B8-12,S9-14", "--comm-every",
     "9", "--seed", "47"],
], ids=["bosco-k4", "r2-k9"])
def test_two_rank_seam_band_deeper_than_k2(tmp_path, argv):
    """A padded periodic 1x2 mesh over 2 ranks with comm_every x r in
    17..31, past K2's 16: the owner of shard (0, 1) steps the band, and
    the group's files equal the reference's single-process run and its
    final board the oracle's."""
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    run_group(argv + ["--save", "--quiet", "--mesh", "1x2"], 2, port)
    name = f"run-{argv[0]}x{argv[1]}-11-s47"
    reference(argv + ["--save"], "1x2", name, ref)
    assert_same_files(ref, port)
    rows, cols = int(argv[0]), int(argv[1])
    from mpi_tpu_torch import golio

    np.testing.assert_array_equal(
        golio.assemble(port, name, 11),
        evolve_np(init_tile_np(rows, cols, 47), 11,
                  rule_from_name(argv[5]), "periodic"))


# -- no stacked batch across a 2-rank group --------------------------------

BATCH_WORKER = """
import sys
from mpi_tpu_torch.backends.cuda import build_engine
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.parallel import dist
from mpi_tpu_torch.parallel.mesh import make_mesh
coordinator, rank = sys.argv[1:3]
dist.initialize(coordinator, 2, int(rank), device="cpu")
try:
    mesh = make_mesh((1, 2), platform="cpu")
    assert mesh.multiprocess
    eng = build_engine(GolConfig(rows=24, cols=90, steps=1), mesh=mesh)
    grid = eng.init_grid(seed=3)
    for call in (lambda: eng.stack_grids([grid, grid]),
                 lambda: eng.init_grids(seeds=[1, 2]),
                 lambda: eng.step_batched(grid, 1)):
        try:
            call()
        except ConfigError as e:
            assert "process group" in str(e), e
        else:
            raise AssertionError("a batch ran across the group")
    assert eng.fetch_batched(grid) is None
    assert eng.batched_step_calls == 0
    print("refused")
finally:
    dist.shutdown()
"""


def test_two_rank_group_refuses_a_stacked_batch():
    """Under a process group the seam has no board axis: ``stack_grids``,
    ``init_grids`` and ``step_batched`` raise ConfigError on every rank
    before any launch, and ``fetch_batched`` answers None, on a padded
    periodic 1x2 mesh whose group seam path a batch would misread."""
    port = free_port("127.0.0.1")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", BATCH_WORKER, f"127.0.0.1:{port}", str(r)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert out.strip() == "refused"
