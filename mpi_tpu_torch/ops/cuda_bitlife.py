"""Kernel K1: the fused SWAR Life pass, hand-written in CUDA for Hopper.

Replaces ``mpi_tpu.ops.pallas_bitlife.pallas_bit_step``: ``gens`` (1..16)
generations of a radius-1 rule on a packed (H, W/32) grid in one read and
one write of device memory.  Two modes the TPU kernel leaves to its
callers: ``col_limit``, the real width of a padded grid, whose pad bits
the kernel zeroes after every generation (the reference's
``parallel/step.py:_mask_pad_cols``), and a board axis, B grids of one
shape stepped alike in one launch (the reference's ``jax.vmap``).  The kernel is ``csrc/bitlife.cu`` (its header
says what bounds it and how it is tiled), built once per rule with the
rule compiled in: ``ops/bit_codegen.py`` emits the rule as straight-line
LOP3s, ``ops/_build.py:load_rule_library`` builds and loads the rule's
library at first use (``Engine.warm_up`` on the engine's path), and rules
with equal birth and survive sets share one.

:func:`cuda_bit_step` launches the kernel for a CUDA tensor.  For a tensor
on the CPU it runs :func:`bit_step_plain`, the plain PyTorch version, and
for nothing else: on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpi_tpu_torch.models.rules import LIFE, Rule
from mpi_tpu_torch.ops._launch import (
    boards, check_col_limit, check_cuda, check_out, raise_on_error,
)
from mpi_tpu_torch.ops.bitlife import WORD, bit_step, mask_pad, packable

MAX_GENS = 16


def refusal(shape, rule: Rule, gens: int = 1,
            boundary: str = "periodic") -> Optional[str]:
    """Why the kernel cannot run ``gens`` generations of ``rule`` on an
    (H, W) cell grid, or None when it can: it serves radius 1, a whole
    number of words per row, 1..16 generations, and no birth-on-0 rule
    beyond one generation (cells beyond a dead edge must stay dead across
    in-tile generations)."""
    H, W = shape
    if rule.radius != 1:
        return f"K1 serves radius-1 rules only, got radius {rule.radius}"
    if boundary not in ("periodic", "dead"):
        return f"unknown boundary {boundary!r}"
    if H < 1 or W < WORD or not packable(shape, rule):
        return (f"the grid must be at least 1x{WORD} cells with a width that "
                f"is a multiple of {WORD}, got {H}x{W}")
    if not 1 <= gens <= MAX_GENS:
        return f"gens must be in 1..{MAX_GENS}, got {gens}"
    if gens > 1 and 0 in rule.birth:
        return "gens > 1 requires a rule without birth-on-0"
    return None


def supports(shape, rule: Rule, gens: int = 1) -> bool:
    """(H, W) cell shapes and depths the kernel serves (see :func:`refusal`)."""
    return refusal(shape, rule, gens) is None


def _check(packed: torch.Tensor, rule: Rule, boundary: str, gens: int,
           col_limit) -> None:
    if packed.dtype != torch.int32:
        raise TypeError(f"packed grid must be int32 words, got {packed.dtype}")
    _, H, NW = boards(packed)
    reason = refusal((H, NW * WORD), rule, gens, boundary)
    if reason:
        raise ValueError(reason)
    check_col_limit(col_limit, NW)


def bit_step_plain(packed: torch.Tensor, rule: Rule = LIFE,
                   boundary: str = "periodic", gens: int = 1,
                   col_limit: Optional[int] = None) -> torch.Tensor:
    """The plain version of K1: ``gens`` applications of ``bit_step`` (to
    every board of a (B, H, NW) batch at once), each followed by zeroing
    the pad at or past ``col_limit``."""
    _check(packed, rule, boundary, gens, col_limit)
    for _ in range(gens):
        packed = mask_pad(bit_step(packed, rule, boundary), col_limit)
    return packed


def cuda_bit_step(packed: torch.Tensor, rule: Rule = LIFE,
                  boundary: str = "periodic", gens: int = 1,
                  out: Optional[torch.Tensor] = None,
                  col_limit: Optional[int] = None) -> torch.Tensor:
    """``gens`` generations of ``rule`` on the packed int32 grid ``packed``,
    (H, NW), or on each board of a (B, H, NW) batch in one launch.

    ``col_limit``: the real width in cells of a padded grid (in
    (32 (NW - 1), 32 NW]); every bit at or past it is zero after every
    generation.  ``out``, when given, receives the result (same shape,
    dtype and device, not overlapping ``packed``: the kernel cannot run in
    place, because neighbouring blocks read each other's rows); otherwise it
    is allocated.  The launch goes to the current stream and does not
    synchronise.  ``cuda_bit_step.launches`` counts kernel launches."""
    _check(packed, rule, boundary, gens, col_limit)
    if out is not None:
        check_out(out, packed, "K1")
    if packed.device.type == "cpu":
        res = bit_step_plain(packed, rule, boundary, gens, col_limit)
        return res if out is None else out.copy_(res)
    check_cuda(packed, "K1")
    from mpi_tpu_torch.ops._build import load_rule_library

    if out is None:
        out = torch.empty_like(packed)
    launch(load_rule_library("bit", rule), packed, out, boundary, gens,
           col_limit)
    cuda_bit_step.launches += 1
    return out


def launch(lib, packed: torch.Tensor, out: torch.Tensor, boundary: str,
           gens: int, col_limit: Optional[int] = None) -> None:
    """One pass of the K1 library ``lib`` (built for the rule) on the
    current stream; raises on a CUDA error.  Checks nothing else: callers
    are :func:`cuda_bit_step` and timing scripts that compare builds."""
    B, H, NW = boards(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = lib.gol_bit_step(packed.data_ptr(), out.data_ptr(), B, H, NW,
                               gens, int(boundary == "periodic"),
                               col_limit or 0, stream)
    raise_on_error(lib, err, "K1")


cuda_bit_step.launches = 0
