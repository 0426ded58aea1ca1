"""Dense stencil step on uint8 0/1 grids, in plain PyTorch: the port's
copy of ``mpi_tpu.ops.stencil`` and the plain version of kernel K2
(``ops/cuda_stencil.py``).

The neighbour count is a separable box sum: a (2r+1)-row window sum, then
a (2r+1)-column window sum of it, minus the centre cell.  Counts stay in
uint8: the largest, (2r+1)² − 1 = 224 at r = 7, fits (``models/rules.py``
caps r at 7).  The rule is applied as OR-of-interval comparisons
(``Rule.*_intervals``).
"""

from __future__ import annotations

from typing import Tuple

import torch

from mpi_tpu_torch.models.rules import LIFE, Rule


def pad_grid(grid: torch.Tensor, radius: int, boundary: str) -> torch.Tensor:
    """(H, W) → (H+2r, W+2r): a toroidal wrap for "periodic", zeros for
    "dead".  The wrap indexes modulo H and W, so a grid smaller than its
    neighbourhood repeats as ``numpy.pad(mode="wrap")`` does."""
    r = radius
    H, W = grid.shape
    if boundary == "periodic":
        rows = torch.arange(-r, H + r, device=grid.device) % H
        cols = torch.arange(-r, W + r, device=grid.device) % W
        return grid[rows][:, cols]
    if boundary == "dead":
        return torch.nn.functional.pad(grid, (r, r, r, r))
    raise ValueError(f"unknown boundary {boundary!r}")


def counts_from_padded(padded: torch.Tensor, radius: int) -> torch.Tensor:
    """Neighbour counts (centre excluded) of the interior of a pre-padded
    (H+2r, W+2r) uint8 grid → (H, W) uint8."""
    r = radius
    H = padded.shape[0] - 2 * r
    W = padded.shape[1] - 2 * r
    win = 2 * r + 1
    rowsum = padded[0:H, :].clone()
    for k in range(1, win):
        rowsum += padded[k:k + H, :]
    counts = rowsum[:, 0:W].clone()
    for k in range(1, win):
        counts += rowsum[:, k:k + W]
    return counts - padded[r:r + H, r:r + W]


def neighbor_counts(grid: torch.Tensor, radius: int,
                    boundary: str) -> torch.Tensor:
    return counts_from_padded(pad_grid(grid, radius, boundary), radius)


def _in_any_interval(counts: torch.Tensor,
                     intervals: Tuple[Tuple[int, int], ...]) -> torch.Tensor:
    acc = torch.zeros(counts.shape, dtype=torch.bool, device=counts.device)
    for lo, hi in intervals:
        if lo == hi:
            acc |= counts == lo
        else:
            acc |= (counts >= lo) & (counts <= hi)
    return acc


def apply_rule(alive: torch.Tensor, counts: torch.Tensor,
               rule: Rule) -> torch.Tensor:
    """Next state from the current state and the neighbour counts."""
    born = _in_any_interval(counts, rule.birth_intervals)
    keep = _in_any_interval(counts, rule.survive_intervals)
    return torch.where(alive.bool(), keep, born).to(torch.uint8)


def step(grid: torch.Tensor, rule: Rule = LIFE,
         boundary: str = "periodic") -> torch.Tensor:
    """One generation of ``rule`` on a (H, W) uint8 0/1 grid."""
    return apply_rule(grid, neighbor_counts(grid, rule.radius, boundary), rule)


def make_stepper(rule: Rule = LIFE, boundary: str = "periodic"):
    """evolve(grid, steps): ``steps`` generations, one ``step`` each."""

    def evolve(grid: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            grid = step(grid, rule, boundary)
        return grid

    return evolve


# Kernel K2's row loop (csrc/stencil.cu, dense_step_body): a thread owns
# GROUP words of four byte cells in a row and steps them one row at a time.
GROUP = 4          # words a thread owns per row (kGroup)
CELLS_PER_WORD = 4


def dense_cell_ops(radius: int) -> float:
    """Instructions kernel K2 issues per cell per generation at ``radius``,
    counted from its row loop in ``csrc/stencil.cu`` (one row of a thread's
    GROUP words, 16 cells), arithmetic and memory instructions only: loop
    control and address arithmetic are the compiler's (``chip_smoke.py``
    phase 1 counts the built loop's SASS at r = 5 beside this count).
    Per row, with M = ⌈r/4⌉ neighbour words a side:

    * the entering and leaving rows' windows, ``load_window`` twice: one
      16-byte load and two more each (6);
    * the sliding vertical sums, ``v = v + e - l`` on GROUP + 2M words, one
      three-input add each;
    * the centre words, one 16-byte load (1);
    * per word: a byte permute for each of the 2r+1 horizontal shifts that
      is not a whole word (``shifted``), r three-input adds for the 2r+1
      terms (``hsum``), two permutes pairing totals with states, four table
      indices (a mask or a shift each), four table loads, three merges of
      the looked-up bytes and one mask with ``keep`` (``nxt``);
    * the store of the four words, one 16-byte store (1)."""
    r = int(radius)
    if not 1 <= r <= 7:
        raise ValueError(f"radius must be in 1..7, got {radius}")
    m = -(-r // 4)
    permutes = sum(1 for s in range(-r, r + 1) if s % 4)
    per_word = permutes + r + 2 + 4 + 4 + 3 + 1
    per_row = 6 + (GROUP + 2 * m) + 1 + GROUP * per_word + 1
    return per_row / (GROUP * CELLS_PER_WORD)
