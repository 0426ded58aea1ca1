"""Activity-gated sparse stepping in the port (``mpi_tpu_torch/ops/activity.py``
and the sparse ``Engine``), on the CPU, against the JAX package's
(``mpi_tpu/ops/activity.py`` through ``mpi_tpu.backends.tpu.build_engine``)
on XLA:CPU and the serial oracle: the tile plan field by field, the map
algebra and the stripe gather on seeded random inputs, and every scenario
of ``tests/test_activity.py`` with the grid, the changed map and
``sparse_stats`` equal to the reference's after each dispatch.  All state
is integer: every comparison is exact."""

import filecmp
import os
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_tpu.backends.serial_np import evolve_np as jax_evolve_np
from mpi_tpu.backends.tpu import build_engine as jax_build
from mpi_tpu.cli import main as jax_main
from mpi_tpu.config import ConfigError as JaxConfigError
from mpi_tpu.config import GolConfig as JaxConfig
from mpi_tpu.models.rules import rule_from_name as jax_rule
from mpi_tpu.ops import activity as ref
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch import interop
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.cli import main as port_main
from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.ops import activity

GLIDER = np.array([[0, 1, 0], [0, 0, 1], [1, 1, 1]], dtype=np.uint8)


def _pair(rows, cols, T, rule="life", boundary="periodic"):
    """The reference's sparse engine and the port's for one config."""
    je = jax_build(JaxConfig(rows=rows, cols=cols, steps=0, backend="tpu",
                             mesh_shape=(1, 1), sparse_tile=T,
                             rule=jax_rule(rule), boundary=boundary))
    pe = port.build_engine(GolConfig(rows=rows, cols=cols, steps=0,
                                     sparse_tile=T, rule=rule_from_name(rule),
                                     boundary=boundary), device="cpu")
    return je, pe


def _same(je, jg, pe, pg, msg=""):
    """Grid, changed map and sparse_stats of the two states are equal."""
    np.testing.assert_array_equal(pe.fetch(pg), np.asarray(je.fetch(jg)),
                                  err_msg=msg)
    np.testing.assert_array_equal(pg.changed.numpy(), np.asarray(jg.changed),
                                  err_msg=msg)
    assert pe.sparse_stats(pg) == je.sparse_stats(jg), msg


# -- the plan and the map algebra ------------------------------------------

PLANS = [
    # rows, cols_units, tile_px, radius, periodic, packed, depth
    (256, 8, 32, 1, True, True, 0),
    (256, 8, 32, 1, False, True, 2),
    (65536, 2048, 128, 1, True, True, 0),      # the smoke run's plan
    (64, 4, 32, 2, True, True, 0),
    (128, 8, 64, 2, False, True, 0),
    (160, 160, 32, 5, True, False, 0),
    (48, 48, 16, 5, False, False, 0),           # gens 3, halo 15
    (64, 2, 32, 5, False, True, 0),             # gens 6, a one-word halo
    (256, 8, 128, 5, True, True, 0),            # gens 8, a two-word halo
    (480, 500, 20, 5, False, False, 0),
    (96, 96, 96, 1, True, False, 0),            # one tile
    (512, 512, 32, 3, True, False, 4),
]


@pytest.mark.parametrize("rows,cols,T,r,periodic,packed,depth", PLANS)
def test_make_plan_matches_the_reference(rows, cols, T, r, periodic, packed,
                                         depth):
    kw = dict(rows=rows, cols_units=cols, tile_px=T, radius=r,
              periodic=periodic, packed=packed, depth=depth)
    want = ref.make_plan(**kw)
    got = activity.make_plan(**kw)
    assert got.__dict__ == want.__dict__
    assert (got.ntiles, got.capacity) == (want.ntiles, want.capacity)
    assert got.stripe_shape(3)[0] == got.tile_r + 2 * got.halo_r


def test_constants_are_the_references():
    assert activity.CAPACITY_FRACS == ref.CAPACITY_FRACS
    assert activity.RELEASE_FRAC == ref.RELEASE_FRAC
    assert activity.DENSE_CHUNKS == ref.DENSE_CHUNKS
    assert activity.DEPTH_TARGET == ref.DEPTH_TARGET


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("shape,density", [((4, 4), 0.1), ((7, 5), 0.2),
                                           ((1, 9), 0.3), ((16, 16), 0.02)])
def test_dilate_and_count_match_the_reference(shape, density, periodic):
    rng = np.random.default_rng(sum(shape) + periodic)
    m = rng.random(shape) < density
    want = np.asarray(ref.dilate_tiles(jnp.asarray(m), periodic))
    got = activity.dilate_tiles(torch.from_numpy(m), periodic)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(activity.active_count(torch.from_numpy(m), periodic)) == \
        int(ref.active_count(jnp.asarray(m), periodic))


@pytest.mark.parametrize("packed", [True, False])
def test_tile_changed_map_matches_the_reference(packed):
    rng = np.random.default_rng(3)
    plan = activity.make_plan(rows=128, cols_units=4 if packed else 128,
                              tile_px=32, radius=1, periodic=True,
                              packed=packed)
    shape = (128, 4) if packed else (128, 128)
    old = rng.integers(0, 2, size=shape, dtype=np.uint8)
    new = old.copy()
    for r, c in rng.integers(0, shape, size=(5, 2)):
        new[r, c] ^= 1
    if packed:
        old, new = old.astype(np.uint32), new.astype(np.uint32)
    want = np.asarray(ref.tile_changed_map(jnp.asarray(new), jnp.asarray(old),
                                           plan))
    conv = (lambda a: torch.from_numpy(a.view(np.int32))) if packed \
        else torch.from_numpy
    got = activity.tile_changed_map(conv(new), conv(old), plan)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 1 <= want.sum() <= 5


@pytest.mark.parametrize("periodic", [True, False])
@pytest.mark.parametrize("packed,T,r,K", [(True, 32, 1, 5), (True, 64, 2, 3),
                                          (False, 16, 5, 4), (False, 8, 1, 9)])
def test_gather_stripe_matches_the_reference(packed, T, r, K, periodic):
    rng = np.random.default_rng(T * K + r)
    rows, cols = 4 * T, (3 * T // 32 if packed else 3 * T)
    plan = activity.make_plan(rows=rows, cols_units=cols, tile_px=T, radius=r,
                              periodic=periodic, packed=packed)
    if packed:
        grid = rng.integers(0, 2**32, size=(rows, cols), dtype=np.uint32)
        tgrid = torch.from_numpy(grid.view(np.int32))
    else:
        grid = rng.integers(0, 2, size=(rows, cols), dtype=np.uint8)
        tgrid = torch.from_numpy(grid)
    idx = rng.integers(0, plan.ntiles, size=K)
    ti, tj = idx // plan.ntj, idx % plan.ntj
    want = np.asarray(ref.gather_stripe(
        jnp.asarray(grid), jnp.asarray(ti, dtype=jnp.int32),
        jnp.asarray(tj, dtype=jnp.int32), plan))
    got = activity.gather_stripe(tgrid, torch.from_numpy(ti),
                                 torch.from_numpy(tj), plan)
    assert tuple(got.shape) == plan.stripe_shape(K) and got.is_contiguous()
    got = got.numpy().view(np.uint32) if packed else got.numpy()
    np.testing.assert_array_equal(got, want)


# -- the scenarios of tests/test_activity.py ----------------------------------

PARITY_CASES = [
    ("life", 64, 64, 32, 12),
    ("life", 128, 128, 32, 25),
    ("highlife", 64, 128, 32, 10),
    ("bosco", 48, 48, 16, 6),
]


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
@pytest.mark.parametrize("rule,rows,cols,T,steps", PARITY_CASES)
def test_sparse_matches_the_reference(rule, rows, cols, T, steps, boundary):
    je, pe = _pair(rows, cols, T, rule, boundary)
    assert pe.sparse_plan.__dict__ == je.sparse_plan.__dict__
    assert pe.kind == ("dense" if rule == "bosco" else "bit")
    jg, pg = je.init_grid(seed=7), pe.init_grid(seed=7)
    _same(je, jg, pe, pg)
    jg, pg = je.step(jg, steps), pe.step(pg, steps)
    _same(je, jg, pe, pg, f"{rule} {rows}x{cols} T={T} {boundary}")
    want = jax_evolve_np(init_tile_np(rows, cols, seed=7), steps,
                         jax_rule(rule), boundary)
    np.testing.assert_array_equal(pe.fetch(pg), want)


def test_unit_chain_matches_deep_dispatch_and_the_reference():
    je, pe = _pair(128, 128, 32)
    a, b = pe.init_grid(seed=11), pe.init_grid(seed=11)
    ja = je.init_grid(seed=11)
    for i in range(17):
        a, ja = pe.step(a, 1), je.step(ja, 1)
        _same(je, ja, pe, a, f"unit {i}")
    b = pe.step(b, 17)
    np.testing.assert_array_equal(pe.fetch(a), pe.fetch(b))


def _glider_board(n=512):
    board = np.zeros((n, n), dtype=np.uint8)
    board[100:103, n - 6:n - 3] = GLIDER   # near the right seam: wraps
    return board


def test_glider_crosses_tiles_and_the_periodic_seam():
    board = _glider_board()
    je, pe = _pair(512, 512, 32)
    dense = port.build_engine(GolConfig(rows=512, cols=512, steps=0),
                              device="cpu")
    jg, pg = je.init_grid(initial=board), pe.init_grid(initial=board)
    gd = dense.init_grid(initial=board)
    for i in range(120):
        jg, pg, gd = je.step(jg, 1), pe.step(pg, 1), dense.step(gd, 1)
        _same(je, jg, pe, pg, f"generation {i + 1}")
    np.testing.assert_array_equal(pe.fetch(pg), dense.fetch(gd))
    st = pe.sparse_stats(pg)
    assert st["mode"] == "sparse" and st["active_tiles"] <= 9
    # one probe settles the all-ones start; then the glider's track takes a
    # depth-1 gather a dispatch and never the dense phase
    phases = pe._evolve.phases
    assert phases["probe", ] == 1 and not any(k[0] == "dense" for k in phases)
    assert sum(v for k, v in phases.items() if k[0] == "sparse") == 119


def test_glider_deep_dispatch():
    board = _glider_board()
    je, pe = _pair(512, 512, 32)
    jg, pg = je.init_grid(initial=board), pe.init_grid(initial=board)
    # the first dispatch starts all-ones: dense chunks and a final probe; the
    # second rides the gathers, six of 8 generations and two of 1
    for _ in range(2):
        jg, pg = je.step(jg, 50), pe.step(pg, 50)
        _same(je, jg, pe, pg)
    np.testing.assert_array_equal(
        pe.fetch(pg), jax_evolve_np(board, 100, jax_rule("life"), "periodic"))
    by_depth = Counter()
    for k, v in pe._evolve.phases.items():
        if k[0] == "sparse":
            by_depth[k[2]] += v
    assert by_depth == {8: 6, 1: 2} and pe._evolve.phases["probe", ] == 1


def test_full_board_death_drains_active_tiles():
    board = np.zeros((64, 64), dtype=np.uint8)
    board[10, 10:12] = 1                   # a domino dies in one step
    je, pe = _pair(64, 64, 32)
    jg, pg = je.init_grid(initial=board), pe.init_grid(initial=board)
    for i in range(40):
        jg, pg = je.step(jg, 1), pe.step(pg, 1)
        _same(je, jg, pe, pg, f"generation {i + 1}")
    st = pe.sparse_stats(pg)
    assert st["active_tiles"] == 0 and st["mode"] == "sparse"
    assert not pe.fetch(pg).any()


def test_reignition_of_a_dead_neighbour_tile():
    board = np.zeros((128, 128), dtype=np.uint8)
    board[31, 30:33] = 1                   # a blinker across the tile edge
    je, pe = _pair(128, 128, 32)
    jg, pg = je.init_grid(initial=board), pe.init_grid(initial=board)
    for i in range(33):
        jg, pg = je.step(jg, 1), pe.step(pg, 1)
        _same(je, jg, pe, pg, f"generation {i + 1}")
    np.testing.assert_array_equal(
        pe.fetch(pg), jax_evolve_np(board, 33, jax_rule("life"), "periodic"))


def test_batched_sparse_matches_the_reference_board_by_board():
    boards = []
    for k in range(3):
        b = np.zeros((64, 64), dtype=np.uint8)
        b[8 * k:8 * k + 3, 40:43] = GLIDER
        boards.append(b)
    je, pe = _pair(64, 64, 32)
    jbatch = je.stack_grids([je.init_grid(initial=b) for b in boards])
    batch = pe.stack_grids([pe.init_grid(initial=b) for b in boards])
    assert tuple(batch.changed.shape) == (3, 2, 2)
    jouts = je.unstack_grids(je.step_batched(jbatch, 9))
    outs = pe.unstack_grids(pe.step_batched(batch, 9))
    for k, b in enumerate(boards):
        _same(je, jouts[k], pe, outs[k], f"board {k}")
        solo = pe.step(pe.init_grid(initial=b), 9)
        np.testing.assert_array_equal(pe.fetch(solo), pe.fetch(outs[k]))
    pops = pe.population_batched(pe.init_grids(initials=boards))
    assert pops == [5, 5, 5]
    assert [f.sum() for f in pe.fetch_batched(batch)] == \
        [int(o.sum()) for o in map(pe.fetch, outs)]


def test_batched_sparse_keeps_no_view_of_the_batch():
    # a busy board runs the dense phase's ping-pong: its result must land in
    # the batch, and the engine's spare must not be a view of the batch
    je, pe = _pair(64, 64, 32)
    batch = pe.init_grids(seeds=[1, 2])
    raw = batch.grid
    for _ in range(3):
        batch = pe.step_batched(batch, 5)
        assert batch.grid.data_ptr() == raw.data_ptr()
        assert all(s.data_ptr() != b.data_ptr() for s in pe._spares.values()
                   for b in raw.unbind(0))
    want = [jax_evolve_np(init_tile_np(64, 64, seed=s), 15, jax_rule("life"),
                          "periodic") for s in (1, 2)]
    for got, w in zip(pe.fetch_batched(batch), want):
        np.testing.assert_array_equal(got, w)


def test_state_from_the_reference_steps_on_in_the_port():
    board = _glider_board(256)
    je, pe = _pair(256, 256, 32)
    jg = je.step(je.init_grid(initial=board), 5)
    pg = interop.sparse_from_numpy(np.asarray(jg.grid), np.asarray(jg.changed),
                                   "cpu")
    _same(je, jg, pe, pg)
    jg, pg = je.step(jg, 7), pe.step(pg, 7)
    _same(je, jg, pe, pg)
    grid, changed = interop.sparse_to_numpy(pg)
    assert grid.dtype == np.uint32 and changed.dtype == np.bool_
    # the reference gets numpy copies: on the CPU these arrays are views of
    # the port's tensors, which the port's next step rewrites in place, and
    # JAX reads a host array after it returns (jnp.asarray aliases it; even
    # jnp.array(copy=True) copies it asynchronously)
    jg2 = je.step(ref.SparseState(jnp.asarray(grid.copy()),
                                  jnp.asarray(changed.copy())), 3)
    pg = pe.step(pg, 3)
    _same(je, jg2, pe, pg)


def test_reference_arrays_from_port_views_alias_the_port_tensors():
    """Why the test above hands the reference copies: on the CPU a numpy
    view of a port tensor becomes a JAX array over the same memory, which
    the port's next in-place step would rewrite under the reference's
    asynchronous step; a numpy copy is the reference's own."""
    _, pe = _pair(64, 64, 32)
    pg = pe.init_grid()
    grid, _ = interop.sparse_to_numpy(pg)
    assert jnp.asarray(grid).unsafe_buffer_pointer() == pg.grid.data_ptr()
    assert jnp.asarray(grid.copy()).unsafe_buffer_pointer() != \
        pg.grid.data_ptr()


def test_sparse_engine_refuses_a_bare_grid():
    _, pe = _pair(64, 64, 32)
    with pytest.raises(TypeError, match="SparseState"):
        pe.step(pe.raw_grid(pe.init_grid()), 1)
    dense = port.build_engine(GolConfig(rows=64, cols=64, steps=0),
                              device="cpu")
    with pytest.raises(TypeError, match="SparseState"):
        dense.step(pe.init_grid(), 1)
    assert dense.sparse_stats(dense.init_grid()) is None


def test_plan_engine_keeps_ragged_ltl_widths_on_k2_as_the_reference():
    je, pe = _pair(48, 48, 16, "bosco", "dead")
    assert (pe.kind, pe.cols_eff, pe.pad_bits) == ("dense", 48, 0)
    assert (je.bitpacked, je.cols_eff, je.pad_bits) == (False, 48, 0)
    assert any("sparse_tile 16" in n for n in pe.notes)
    assert any("host reads the active count" in n for n in pe.notes)


# -- refusals, through GolConfig, build_engine and the CLI ----------------------

REFUSALS = [
    dict(rows=64, cols=64, sparse_tile=48),                   # does not divide
    dict(rows=64, cols=64, sparse_tile=-1),
    dict(rows=64, cols=64, sparse_tile=32, comm_every=2),
    dict(rows=64, cols=64, sparse_tile=4, rule="bosco"),      # T < r
    dict(rows=64, cols=64, sparse_tile=32, backend="serial"),
    dict(rows=64, cols=64, sparse_tile=16),                   # T % 32, packed
    dict(rows=64, cols=128, sparse_tile=16, rule="highlife",
         boundary="dead"),
]


def _message(exc) -> str:
    return str(exc).replace("tpu backend", "cuda backend")


@pytest.mark.parametrize("kw", REFUSALS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_refusals_match_the_reference(kw):
    kw = dict(kw)
    rule = kw.pop("rule", "life")
    backend = kw.pop("backend", None)
    with pytest.raises(JaxConfigError) as want:
        jax_build(JaxConfig(steps=0, backend=backend or "tpu",
                            mesh_shape=(1, 1) if backend is None else None,
                            rule=jax_rule(rule), **kw))
    with pytest.raises(ConfigError) as got:
        port.build_engine(GolConfig(steps=0, backend=backend or "cuda",
                                    rule=rule_from_name(rule), **kw),
                          device="cpu")
    assert str(got.value) == _message(want.value)


@pytest.mark.parametrize("args", [
    ["64", "64", "0", "4", "--sparse", "48"],
    ["64", "64", "0", "4", "--sparse", "32", "--comm-every", "2"],
    ["64", "64", "0", "4", "--sparse", "16"],
    ["64", "64", "0", "4", "--sparse", "32", "--backend", "serial"],
    # auto picks 8 for Life where the fused kernel serves the width, which
    # sparse stepping refuses
    ["64", "4096", "0", "4", "--sparse", "32", "--comm-every", "auto"],
], ids=["divide", "comm-every", "words", "serial", "auto"])
def test_cli_refusals_match_the_reference(args, tmp_path, capsys, monkeypatch):
    # the reference's auto policy takes its fused kernels, at TPU widths,
    # only where they run: here in interpret mode
    monkeypatch.setenv("MPI_TPU_PALLAS_INTERPRET", "1")
    common = ["--quiet", "--out-dir", str(tmp_path / "x")]
    assert jax_main(args + common + ["--mesh", "1x1"]) == 2
    want = capsys.readouterr().err.strip().splitlines()[-1]
    assert port_main(args + common + ["--device", "cpu"]) == 2
    got = capsys.readouterr().err.strip().splitlines()[-1]
    assert got == want.replace("tpu backend", "cuda backend")


@pytest.mark.parametrize("rule,size,T", [("life", 64, 32), ("bosco", 48, 16),
                                         ("highlife", 96, 32)])
@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_cli_sparse_gol_files_equal_the_serial_oracle(rule, size, T, boundary,
                                                      tmp_path):
    common = [str(size), str(size), "5", "17", "--save", "--seed", "3",
              "--rule", rule, "--boundary", boundary, "--quiet", "--name", "n"]
    cu, ser = str(tmp_path / "cu"), str(tmp_path / "se")
    assert port_main(common + ["--out-dir", cu, "--sparse", str(T),
                               "--device", "cpu"]) == 0
    assert port_main(common + ["--out-dir", ser, "--backend", "serial"]) == 0
    names = sorted(f for f in os.listdir(ser) if f.endswith(".gol"))
    _, mismatch, errors = filecmp.cmpfiles(ser, cu, names, shallow=False)
    assert len(names) == 6 and not mismatch and not errors  # master + 5
