"""Kernel K2: the dense stencil pass, hand-written in CUDA for Hopper.

Replaces ``mpi_tpu.ops.pallas_stencil.pallas_step``: ``gens`` generations
(gens·r ≤ 16) of any radius-r rule (1..7) on a (H, W) uint8 0/1 grid in
one read and one write of device memory, on one grid or on each board of
a (B, H, W) batch in one launch.  The kernel is
``csrc/stencil.cu`` (its header says what bounds it and how it is tiled);
``ops/_build.py`` builds it.  Unlike the TPU kernel it takes any H, W >= 1.

:func:`cuda_dense_step` launches the kernel for a CUDA tensor.  For a
tensor on the CPU it runs :func:`dense_step_plain`, the plain PyTorch
version, and for nothing else: on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mpi_tpu_torch.models.rules import LIFE, Rule
from mpi_tpu_torch.ops._launch import (
    boards, check_cuda, check_out, raise_on_error,
)
from mpi_tpu_torch.ops.stencil import step

MAX_DEPTH = 16  # gens x radius: the deepest halo a tile carries


def refusal(shape, rule: Rule, gens: int = 1,
            boundary: str = "periodic") -> Optional[str]:
    """Why the kernel cannot run ``gens`` generations of ``rule`` on an
    (H, W) grid, or None when it can: any H, W >= 1, gens·r <= 16, and no
    birth-on-0 rule beyond one generation (cells beyond a dead edge must
    stay dead across in-tile generations)."""
    H, W = shape
    if boundary not in ("periodic", "dead"):
        return f"unknown boundary {boundary!r}"
    if H < 1 or W < 1:
        return f"the grid must be at least 1x1 cells, got {H}x{W}"
    if gens < 1 or gens * rule.radius > MAX_DEPTH:
        return (f"gens x radius must be in 1..{MAX_DEPTH}, got "
                f"{gens} x {rule.radius}")
    if gens > 1 and 0 in rule.birth:
        return "gens > 1 requires a rule without birth-on-0"
    return None


def supports(shape, rule: Rule, gens: int = 1) -> bool:
    """(H, W) shapes and depths the kernel serves (see :func:`refusal`)."""
    return refusal(shape, rule, gens) is None


def _check(grid: torch.Tensor, rule: Rule, boundary: str, gens: int) -> None:
    if grid.dtype != torch.uint8:
        raise TypeError(f"dense grid must be uint8 cells, got {grid.dtype}")
    _, H, W = boards(grid)
    reason = refusal((H, W), rule, gens, boundary)
    if reason:
        raise ValueError(reason)


def rule_table(rule: Rule):
    """The rule as 16 words of bits: bit c of words 0..7 is set when a dead
    cell with c neighbours is born, of words 8..15 when a live one stays."""
    words = (ctypes.c_uint * 16)()
    for c in rule.birth:
        words[c // 32] |= 1 << (c % 32)
    for c in rule.survive:
        words[8 + c // 32] |= 1 << (c % 32)
    return words


def dense_step_plain(grid: torch.Tensor, rule: Rule = LIFE,
                     boundary: str = "periodic", gens: int = 1) -> torch.Tensor:
    """The plain version of K2: ``gens`` applications of ``stencil.step``;
    board by board for a (B, H, W) batch."""
    _check(grid, rule, boundary, gens)
    if grid.dim() == 3:
        return torch.stack([dense_step_plain(b, rule, boundary, gens)
                            for b in grid])
    for _ in range(gens):
        grid = step(grid, rule, boundary)
    return grid


def cuda_dense_step(grid: torch.Tensor, rule: Rule = LIFE,
                    boundary: str = "periodic", gens: int = 1,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``gens`` generations of ``rule`` on the uint8 0/1 grid ``grid``,
    (H, W), or on each board of a (B, H, W) batch in one launch.

    ``out``, when given, receives the result (same shape, dtype and device,
    not overlapping ``grid``); otherwise it is allocated.  The launch goes
    to the current stream and does not synchronise.
    ``cuda_dense_step.launches`` counts kernel launches."""
    _check(grid, rule, boundary, gens)
    if out is not None:
        check_out(out, grid, "K2")
    if grid.device.type == "cpu":
        res = dense_step_plain(grid, rule, boundary, gens)
        return res if out is None else out.copy_(res)
    check_cuda(grid, "K2")
    from mpi_tpu_torch.ops._build import load_library

    lib = load_library()
    if out is None:
        out = torch.empty_like(grid)
    B, H, W = boards(grid)
    with torch.cuda.device(grid.device):
        stream = torch.cuda.current_stream(grid.device).cuda_stream
        err = lib.gol_dense_step(
            grid.data_ptr(), out.data_ptr(), B, H, W, rule.radius, gens,
            int(boundary == "periodic"), rule_table(rule), stream,
        )
    raise_on_error(lib, err, "K2")
    cuda_dense_step.launches += 1
    return out


cuda_dense_step.launches = 0
