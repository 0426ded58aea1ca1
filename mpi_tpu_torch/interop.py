"""Carry state between the JAX package and the port: packed uint32 words
as numpy arrays on one side, int32 tensors of the same bit pattern on the
other; dense uint8 0/1 cells as numpy arrays and uint8 tensors; a sparse
engine's state (the grid and its bool tile map); and rules rebuilt from
their fields."""

from __future__ import annotations

import numpy as np
import torch

from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops.activity import SparseState


def grid_from_numpy(packed_u32: np.ndarray, device) -> torch.Tensor:
    """uint32 packed words → an int32 tensor on ``device``, bit for bit."""
    words = np.ascontiguousarray(packed_u32)
    if words.dtype != np.uint32:
        raise TypeError(f"packed words must be uint32, got {words.dtype}")
    return torch.from_numpy(words.view(np.int32)).to(device)


def grid_to_numpy(t: torch.Tensor) -> np.ndarray:
    """An int32 tensor of packed words → uint32 numpy words, bit for bit."""
    if t.dtype != torch.int32:
        raise TypeError(f"packed words must be int32, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy().view(np.uint32)


def dense_from_numpy(cells: np.ndarray, device) -> torch.Tensor:
    """A uint8 0/1 (H, W) array → a uint8 tensor on ``device``."""
    cells = np.ascontiguousarray(cells)
    if cells.dtype != np.uint8 or cells.ndim != 2:
        raise TypeError(f"dense cells must be a 2-D uint8 array, got "
                        f"{cells.dtype} {cells.shape}")
    return torch.from_numpy(cells).to(device)


def dense_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A uint8 (H, W) tensor → a uint8 numpy array."""
    if t.dtype != torch.uint8:
        raise TypeError(f"dense cells must be uint8, got {t.dtype}")
    return t.detach().cpu().contiguous().numpy()


def sparse_from_numpy(grid: np.ndarray, changed: np.ndarray,
                      device) -> SparseState:
    """The fields of a reference ``SparseState`` as numpy arrays (uint32
    packed words or uint8 cells, and the bool tile map, each with or
    without a leading board axis) → the port's ``SparseState`` on
    ``device``, in buffers of its own (the engine writes a sparse grid in
    place)."""
    grid = np.array(grid, order="C")
    changed = np.array(changed, order="C")
    if changed.dtype != np.bool_ or changed.ndim != grid.ndim:
        raise TypeError(f"the tile map must be bool of the grid's rank, got "
                        f"{changed.dtype} {changed.shape}")
    if grid.dtype == np.uint32:
        t = torch.from_numpy(grid.view(np.int32))
    elif grid.dtype == np.uint8:
        t = torch.from_numpy(grid)
    else:
        raise TypeError(f"the grid must be uint32 words or uint8 cells, got "
                        f"{grid.dtype}")
    return SparseState(t.to(device), torch.from_numpy(changed).to(device))


def sparse_to_numpy(state: SparseState):
    """A port ``SparseState`` → (grid, changed) numpy arrays, the fields of
    the reference's ``SparseState``: packed words as uint32, cells as
    uint8, the tile map as bool."""
    grid = state.grid.detach().cpu().contiguous().numpy()
    if grid.dtype == np.int32:
        grid = grid.view(np.uint32)
    return grid, state.changed.detach().cpu().numpy()


def rule_from_fields(name: str, birth, survive, radius: int = 1) -> Rule:
    """The port's Rule with these fields (a reference ``Rule``'s ``name``,
    ``birth``, ``survive`` and ``radius``)."""
    return Rule(name, frozenset(birth), frozenset(survive), radius)
