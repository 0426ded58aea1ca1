"""Decomposition-invariant grid initialisation.

Cell (i, j) is alive iff ``fmix32-chain(seed, i, j) % 3 == 0``, a hash of
the global coordinate only, so any tile of any decomposition, on any
backend, starts from the same cells.  The hash is murmur3's 32-bit
finaliser applied twice, with the row and column keys folded in by odd
multiplicative constants; it matches ``mpi_tpu.utils.hashinit`` bit for bit.

Torch has no full uint32 arithmetic, so :func:`init_tile_torch` computes on
int32 bit patterns: multiplication wraps modulo 2³² as uint32 would, every
right shift is masked (int32 ``>>`` is arithmetic), and the final ``% 3``
is taken on the value read as unsigned.
"""

from __future__ import annotations

import numpy as np
import torch

# Odd constants: golden-ratio Weyl constant and murmur3 finaliser constants.
_KI = 0x9E3779B1
_KJ = 0x85EBCA77
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _fmix32_np(h: np.ndarray) -> np.ndarray:
    """murmur3 32-bit avalanche finaliser on uint32 arrays (wrapping)."""
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(_M1)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(_M2)
    h = h ^ (h >> np.uint32(16))
    return h


def cell_hash_np(seed: int, i: np.ndarray, j: np.ndarray) -> np.ndarray:
    """uint32 hash of (seed, i, j); i/j broadcastable integer arrays."""
    i = i.astype(np.uint32) * np.uint32(_KI)
    j = j.astype(np.uint32) * np.uint32(_KJ)
    h = _fmix32_np(np.uint32(seed) ^ i)
    return _fmix32_np(h ^ j)


def init_tile_np(
    rows: int,
    cols: int,
    seed: int,
    row_offset: int = 0,
    col_offset: int = 0,
) -> np.ndarray:
    """A (rows, cols) uint8 0/1 tile of the global grid starting at
    (row_offset, col_offset)."""
    i = np.arange(row_offset, row_offset + rows, dtype=np.uint32)[:, None]
    j = np.arange(col_offset, col_offset + cols, dtype=np.uint32)[None, :]
    h = cell_hash_np(seed, i, j)
    return (h % np.uint32(3) == 0).astype(np.uint8)


def as_i32(v: int) -> int:
    """The int32 whose bit pattern is ``v`` modulo 2³²."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= (1 << 31) else v


def i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2³²) → the int32 tensor of the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _wrapped_range(start: int, n: int, device) -> torch.Tensor:
    """``start + arange(n)`` modulo 2³², as int32 bit patterns."""
    r = (torch.arange(n, dtype=torch.int64, device=device)
         + (int(start) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return i32_bits(r)


def _fmix32_torch(h: torch.Tensor) -> torch.Tensor:
    h = h ^ ((h >> 16) & 0xFFFF)
    h = h * as_i32(_M1)
    h = h ^ ((h >> 13) & 0x7FFFF)
    h = h * as_i32(_M2)
    h = h ^ ((h >> 16) & 0xFFFF)
    return h


def init_tile_torch(
    rows: int,
    cols: int,
    seed: int,
    row_offset: int = 0,
    col_offset: int = 0,
    device="cuda",
) -> torch.Tensor:
    """Torch twin of :func:`init_tile_np`: a (rows, cols) uint8 0/1 tile on
    ``device``.  Offsets wrap as uint32, as the reference's do."""
    i = _wrapped_range(row_offset, rows, device)[:, None] * as_i32(_KI)
    j = _wrapped_range(col_offset, cols, device)[None, :] * as_i32(_KJ)
    h = _fmix32_torch(i ^ as_i32(seed))
    h = _fmix32_torch(h ^ j)
    return ((h.to(torch.int64) & 0xFFFFFFFF) % 3 == 0).to(torch.uint8)


def init_dense(rows: int, cols: int, seed: int, device="cuda",
               block_rows: int = 1024) -> torch.Tensor:
    """The whole (rows, cols) grid as uint8 0/1 on ``device``, hashed a
    block of rows at a time so the int64 intermediates stay small."""
    out = torch.empty((rows, cols), dtype=torch.uint8, device=device)
    for r0 in range(0, rows, block_rows):
        n = min(block_rows, rows - r0)
        out[r0:r0 + n] = init_tile_torch(n, cols, seed, r0, device=device)
    return out
