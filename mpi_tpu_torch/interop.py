"""Carry state between the JAX package and the port: packed uint32 words
as numpy arrays on one side, int32 tensors of the same bit pattern on the
other; dense uint8 0/1 cells as numpy arrays and uint8 tensors; and rules
rebuilt from their fields."""

from __future__ import annotations

import numpy as np
import torch

from mpi_tpu_torch.models.rules import Rule


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


def rule_from_fields(name: str, birth, survive, radius: int = 1) -> Rule:
    """The port's Rule with these fields (a reference ``Rule``'s ``name``,
    ``birth``, ``survive`` and ``radius``)."""
    return Rule(name, frozenset(birth), frozenset(survive), radius)
