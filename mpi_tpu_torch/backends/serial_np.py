"""Pure-numpy serial oracle, the port's own copy of
``mpi_tpu.backends.serial_np``.

It uses another algorithm than the packed engine (a full shifted-add
neighbour sum and a rule table lookup), so comparing the two compares
independent derivations.  It serves any radius and any width.
"""

from __future__ import annotations

import numpy as np

from mpi_tpu_torch.models.rules import LIFE, Rule
from mpi_tpu_torch.utils.hashinit import init_tile_np


def counts_np(grid: np.ndarray, radius: int, boundary: str) -> np.ndarray:
    """Neighbour counts (centre excluded), full (2r+1)² shifted-add sum."""
    r = radius
    if boundary == "periodic":
        p = np.pad(grid, r, mode="wrap")
    elif boundary == "dead":
        p = np.pad(grid, r, mode="constant")
    else:
        raise ValueError(f"unknown boundary {boundary!r}")
    H, W = grid.shape
    c = np.zeros((H, W), dtype=np.uint8)
    for di in range(2 * r + 1):
        for dj in range(2 * r + 1):
            if di == r and dj == r:
                continue
            c += p[di : di + H, dj : dj + W]
    return c


def step_np(grid: np.ndarray, rule: Rule = LIFE, boundary: str = "periodic") -> np.ndarray:
    """One generation, via rule lookup tables."""
    c = counts_np(grid, rule.radius, boundary)
    birth_table, survive_table = rule.tables()
    alive = grid.astype(bool)
    return np.where(alive, survive_table[c], birth_table[c]).astype(np.uint8)


def evolve_np(
    grid: np.ndarray,
    steps: int,
    rule: Rule = LIFE,
    boundary: str = "periodic",
) -> np.ndarray:
    for _ in range(steps):
        grid = step_np(grid, rule, boundary)
    return grid



def run_serial(config) -> np.ndarray:
    """Init + evolve per a GolConfig; returns the final grid."""
    grid = init_tile_np(config.rows, config.cols, config.seed)
    return evolve_np(grid, config.steps, config.rule, config.boundary)
