"""The port's hash init against the JAX package's, bit for bit, on the CPU."""

import numpy as np
import pytest
import torch

from mpi_tpu.utils.hashinit import init_tile_jnp, init_tile_np
from mpi_tpu_torch.utils import hashinit as port


# offsets near 2^31 and 2^32 exercise the uint32 wrap on int32 words
@pytest.mark.parametrize("rows,cols,seed,r0,c0", [
    (8, 64, 0, 0, 0),
    (5, 33, 42, 7, 11),
    (6, 40, 2**32 - 1, 2**31 - 3, 5),
    (6, 40, 7, 123, 2**31 + 7),
    (4, 50, 2**31, 2**32 - 2, 2**32 - 5),
    (3, 17, 123456789, 2**32 - 1, 2**31 - 1),
])
def test_init_tile_torch_matches_jax(rows, cols, seed, r0, c0):
    want = np.asarray(init_tile_jnp(rows, cols, seed, row_offset=r0,
                                    col_offset=c0))
    got = port.init_tile_torch(rows, cols, seed, r0, c0, device="cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", [0, 3, 2**32 - 7])
def test_init_tile_np_copy_matches_reference(seed):
    np.testing.assert_array_equal(
        port.init_tile_np(19, 45, seed, 3, 9), init_tile_np(19, 45, seed, 3, 9))


def test_tiles_stitch_to_the_global_grid():
    whole = port.init_tile_torch(12, 64, 5, device="cpu")
    parts = [port.init_tile_torch(4, 32, 5, r, c, device="cpu")
             for r in (0, 4, 8) for c in (0, 32)]
    stitched = torch.cat([torch.cat(parts[i:i + 2], dim=1)
                          for i in range(0, 6, 2)], dim=0)
    assert torch.equal(stitched, whole)


def test_as_i32_bit_patterns():
    for v in (0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32 + 5):
        assert port.as_i32(v) & 0xFFFFFFFF == v & 0xFFFFFFFF
        assert -2**31 <= port.as_i32(v) < 2**31


@pytest.mark.parametrize("block_rows", [1, 4, 1024])
def test_init_dense_matches_jax_in_any_block(block_rows):
    want = np.asarray(init_tile_jnp(11, 45, 9))
    got = port.init_dense(11, 45, 9, device="cpu", block_rows=block_rows)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
