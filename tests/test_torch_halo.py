"""The port's halo exchange (``mpi_tpu_torch/parallel/halo.py``) against the
reference's ``exchange_halo``/``exchange_halo_rc`` run inside ``shard_map``
on its 8 virtual CPU devices: every shard's ghost-extended tile, bit for
bit, on every mesh shape the reference's tests use, both boundaries,
depths 1..4, with square ghosts (the dense stepper's) and with one ghost
word column (the packed steppers'); the ``drop_dead`` form, the slab
depths, the exchange records and the sharded carry of ``interop``."""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

from mpi_tpu.parallel.halo import exchange_halo_rc as jax_exchange_halo_rc
from mpi_tpu.parallel.halo import expected_slab_depths as jax_slab_depths
from mpi_tpu.parallel.mesh import AXES as JAX_AXES
from mpi_tpu.parallel.mesh import make_mesh as jax_make_mesh
from mpi_tpu.parallel.step import shard_map
from mpi_tpu_torch import interop
from mpi_tpu_torch.ops import _launch
from mpi_tpu_torch.parallel import halo
from mpi_tpu_torch.parallel.mesh import AXES, make_mesh

SHAPES = [(1, 2), (2, 1), (2, 2), (2, 4), (1, 8), (8, 1)]


def _grid(shape, seed, dtype=np.uint32):
    rng = np.random.default_rng(seed)
    if dtype == np.uint32:
        return rng.integers(0, 2 ** 32, size=shape, dtype=np.uint64).astype(
            np.uint32)
    return rng.integers(0, 2, size=shape, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _jax_exchange(mesh_shape, rr, rc, boundary):
    mesh = jax_make_mesh(mesh_shape)
    spec = PartitionSpec(*JAX_AXES)
    return jax.jit(shard_map(
        lambda x: jax_exchange_halo_rc(x, rr, rc, boundary),
        mesh=mesh, in_specs=spec, out_specs=spec))


def _port_exchange(grid, mesh_shape, rr, rc, boundary, **kw):
    mesh = make_mesh(mesh_shape, platform="cpu")
    shards = interop.shards_from_numpy(grid, mesh)
    ext = halo.exchange_halo_rc(shards, rr, rc, boundary, **kw)
    return ext, interop.shards_to_numpy(ext)


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
@pytest.mark.parametrize("depth", [1, 2, 3, 4])
@pytest.mark.parametrize("mesh_shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("packed", [False, True], ids=["dense", "word"])
def test_exchange_equals_the_reference(packed, mesh_shape, depth, boundary):
    mi, mj = mesh_shape
    # 16 rows and columns a shard: deep enough for every depth
    dtype = np.uint32 if packed else np.uint8
    grid = _grid((16 * mi, 16 * mj), seed=depth + 10 * mi + mj, dtype=dtype)
    rc = 1 if packed else depth
    want = np.asarray(_jax_exchange(mesh_shape, depth, rc, boundary)(grid))
    ext, got = _port_exchange(grid, mesh_shape, depth, rc, boundary)
    assert got.dtype == grid.dtype
    np.testing.assert_array_equal(got, want)
    assert all(t.shape == (16 + 2 * depth, 16 + 2 * rc)
               for row in ext for t in row)


@pytest.mark.parametrize("mesh_shape", [(2, 2), (1, 8), (8, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_drop_dead_leaves_off_the_zero_ghosts(mesh_shape):
    """On a dead boundary the steppers' form keeps exactly the reference's
    tile with the ghosts past the global edge cut off."""
    grid = _grid((8 * mesh_shape[0], 8 * mesh_shape[1]), seed=3)
    _, full = _port_exchange(grid, mesh_shape, 2, 1, "dead")
    ext, _ = _port_exchange(grid, mesh_shape, 2, 1, "dead", drop_dead=True)
    mi, mj = mesh_shape
    for i in range(mi):
        for j in range(mj):
            t = 0 if i == 0 else 2
            b = 0 if i == mi - 1 else 2
            left = 0 if j == 0 else 1
            right = 0 if j == mj - 1 else 1
            tile = full[i * 12:(i + 1) * 12, j * 10:(j + 1) * 10]
            want = tile[2 - t:12 - (2 - b), 1 - left:10 - (1 - right)]
            np.testing.assert_array_equal(
                interop.grid_to_numpy(ext[i][j]), want)


def test_periodic_drop_dead_is_the_full_exchange():
    grid = _grid((16, 32), seed=4)
    _, full = _port_exchange(grid, (2, 2), 3, 1, "periodic")
    _, kept = _port_exchange(grid, (2, 2), 3, 1, "periodic", drop_dead=True)
    np.testing.assert_array_equal(full, kept)


@pytest.mark.parametrize("radius,comm,packed", [
    (1, 1, True), (1, 8, True), (2, 4, True), (5, 6, True), (2, 16, False),
    (5, 3, False)])
def test_slab_depths_equal_the_reference(radius, comm, packed):
    assert halo.expected_slab_depths(radius, comm, packed) == \
        jax_slab_depths(radius, comm, packed)


class _Rec:
    def __init__(self):
        self.exchanges = []

    def exchange(self, axis, pairs, shape):
        self.exchanges.append((axis, pairs, shape))


@pytest.mark.parametrize("boundary", ["periodic", "dead"])
def test_exchange_records_the_reference_ppermutes(boundary):
    """Each ppermute is recorded once with the reference's (src, dst)
    pairs: forward and backward on the rows axis, then on the columns
    axis with the row-extended slab; a 1-wide axis sends nothing."""
    rec = _Rec()
    prev = _launch.arm(rec)
    try:
        _port_exchange(_grid((24, 64), 5), (3, 2), 2, 1, boundary)
        _port_exchange(_grid((24, 64), 5), (1, 2), 2, 1, boundary)
    finally:
        _launch.arm(prev)
    ring = boundary == "periodic"
    fwd3 = ((0, 1), (1, 2)) + (((2, 0),) if ring else ())
    bwd3 = ((1, 0), (2, 1)) + (((0, 2),) if ring else ())
    fwd2 = ((0, 1),) + (((1, 0),) if ring else ())
    bwd2 = ((1, 0),) + (((0, 1),) if ring else ())
    assert rec.exchanges == [
        (AXES[0], fwd3, (2, 32)), (AXES[0], bwd3, (2, 32)),
        (AXES[1], fwd2, (12, 1)), (AXES[1], bwd2, (12, 1)),
        (AXES[1], fwd2, (28, 1)), (AXES[1], bwd2, (28, 1)),
    ]


@pytest.mark.parametrize("mesh_shape", [(2, 4), (8, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("dtype", [np.uint32, np.uint8])
def test_sharded_carry_round_trips_the_reference_array(mesh_shape, dtype):
    """``interop.shards_from_numpy`` splits ``np.asarray`` of the
    reference's sharded array into the port's shards, each the reference
    shard's data, and ``shards_to_numpy`` gives the array back."""
    grid = _grid((16 * mesh_shape[0], 8 * mesh_shape[1]), 6, dtype)
    mesh = jax_make_mesh(mesh_shape)
    arr = jax.device_put(grid, jax.sharding.NamedSharding(
        mesh, PartitionSpec(*JAX_AXES)))
    shards = interop.shards_from_numpy(np.asarray(arr),
                                       make_mesh(mesh_shape, platform="cpu"))
    for s in arr.addressable_shards:
        i = (s.index[0].start or 0) // 16
        j = (s.index[1].start or 0) // 8
        t = shards[i][j]
        assert t.is_contiguous() and t.device == torch.device("cpu")
        got = interop.grid_to_numpy(t) if dtype == np.uint32 else \
            interop.dense_to_numpy(t)
        np.testing.assert_array_equal(got, np.asarray(s.data))
    np.testing.assert_array_equal(interop.shards_to_numpy(shards), grid)
