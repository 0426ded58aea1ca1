"""The benchmark's inputs: random boards made from ``--seed`` on the
device, in the packed layout of ``reference/cells.py``, a block of rows at
a time so that no full-size float array is ever held."""

from __future__ import annotations

import torch

from portbench.reference.cells import pack, words

# cells drawn in one call: bounds the float block on the device
_BLOCK_CELLS = 1 << 28


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from ``seed`` (any whole number;
    taken modulo 2**64)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    return g


def soup(gen: torch.Generator, boards: int, rows: int, cols: int,
         density: float, device) -> torch.Tensor:
    """(boards, rows, words(cols)) int32: each cell live with probability
    ``density``, the pad past ``cols`` dead."""
    out = torch.empty((boards, rows, words(cols)), dtype=torch.int32,
                      device=device)
    step = max(1, _BLOCK_CELLS // cols)
    for b in range(boards):
        for r0 in range(0, rows, step):
            h = min(step, rows - r0)
            cells = torch.rand((h, cols), generator=gen, device=device)
            out[b, r0:r0 + h] = pack((cells < density).to(torch.uint8))
    return out
