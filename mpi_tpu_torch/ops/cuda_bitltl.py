"""Kernel K3: the fused bit-sliced Larger-than-Life pass, hand-written in
CUDA for Hopper.

Replaces ``mpi_tpu.ops.pallas_bitltl.pallas_ltl_step``: ``gens``
(1..⌊8/r⌋) generations of a radius-r rule (2..7) on a packed (H, W/32)
grid in one read and one write of device memory, with the two modes of
K1 (``ops/cuda_bitlife.py``): ``col_limit`` for a padded grid and a board
axis.  The kernel is
``csrc/bitltl.cu`` (its header says what bounds it and how it is tiled),
built once per rule with the rule compiled in (``ops/ltl_codegen.py``
emits it, ``ops/_build.py:load_rule_library`` builds and loads it at first
use).  Unlike the TPU kernel it takes any H >= 1 and any whole number of
words per row.

:func:`cuda_ltl_step` launches the kernel for a CUDA tensor.  For a tensor
on the CPU it runs :func:`ltl_step_plain`, the plain PyTorch version, and
for nothing else: on a CUDA tensor it launches or raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpi_tpu_torch.models.rules import Rule
from mpi_tpu_torch.ops._launch import (
    boards, check_col_limit, check_cuda, check_out, raise_on_error, recording,
)
from mpi_tpu_torch.ops.bitlife import WORD, mask_pad
from mpi_tpu_torch.ops.bitltl import ltl_step

HALO = 8  # rows of halo per side: gens · radius may not exceed it
# rows a warp steps, from -DK3_ROWS (csrc/bitltl.cu; 256 by default): the
# run of rows each warp slides its window down, which the kernel rounds up
# to whole iterations of its row loop, and shortens at gens 1 for r <= 3
# and on a grid too small to fill the card
BLOCK_ROWS = (512, 256, 128, 64, 32)
DEFAULT_ROWS = 256


def max_gens(radius: int) -> int:
    """Deepest temporal blocking the 8-row halo admits: ⌊8/r⌋."""
    return max(1, HALO // radius)


def blocks_ok(rows: int, radius: int, H: int = 1) -> bool:
    """Whether a build whose warps step runs of ``rows`` rows can run a
    radius-r rule on an H grid: a run length the kernel is built with, and
    a radius it serves.  The kernel takes no shared memory at gens 1 and
    at most 36 KB deeper, whatever the run, and lengthens the runs of a
    grid taller than 65535 of them, so neither the run nor H limits it."""
    return rows in BLOCK_ROWS and 2 <= radius <= 7


def block_defines(blocks) -> dict:
    """The macros of the build with CTA tile ``blocks`` = [rows]."""
    (rows,) = (int(v) for v in blocks)
    return {"K3_ROWS": rows}


def refusal(shape, rule: Rule, gens: int = 1,
            boundary: str = "periodic") -> Optional[str]:
    """Why the kernel cannot run ``gens`` generations of ``rule`` on an
    (H, W) cell grid, or None when it can: radius 2..7, a whole number of
    words per row, 1..max_gens(r) generations, and no birth-on-0 rule
    beyond one generation."""
    H, W = shape
    r = rule.radius
    if not 2 <= r <= 7:
        return f"K3 serves radius 2..7, got radius {r} (K1 serves radius 1)"
    if boundary not in ("periodic", "dead"):
        return f"unknown boundary {boundary!r}"
    if H < 1 or W < WORD or W % WORD:
        return (f"the grid must be at least 1x{WORD} cells with a width that "
                f"is a multiple of {WORD}, got {H}x{W}")
    if not 1 <= gens <= max_gens(r):
        return f"gens must be in 1..{max_gens(r)} for radius {r}, got {gens}"
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


def ltl_step_plain(packed: torch.Tensor, rule: Rule,
                   boundary: str = "periodic", gens: int = 1,
                   col_limit: Optional[int] = None) -> torch.Tensor:
    """The plain version of K3: ``gens`` applications of ``ltl_step``, each
    followed by zeroing the pad at or past ``col_limit``; board by board
    for a (B, H, NW) batch."""
    _check(packed, rule, boundary, gens, col_limit)
    if packed.dim() == 3:
        return torch.stack([ltl_step_plain(b, rule, boundary, gens, col_limit)
                            for b in packed])
    for _ in range(gens):
        packed = mask_pad(ltl_step(packed, rule, boundary), col_limit)
    return packed


def cuda_ltl_step(packed: torch.Tensor, rule: Rule,
                  boundary: str = "periodic", gens: int = 1,
                  out: Optional[torch.Tensor] = None,
                  col_limit: Optional[int] = None,
                  defines: Optional[dict] = None) -> torch.Tensor:
    """``gens`` generations of the radius-r ``rule`` on the packed int32
    grid ``packed``, (H, NW), or on each board of a (B, H, NW) batch in one
    launch.

    ``col_limit``: the real width in cells of a padded grid (in
    (32 (NW - 1), 32 NW]); every bit at or past it is zero after every
    generation.  ``out``, when given, receives the result (same shape,
    dtype and device, not overlapping ``packed``); otherwise it is
    allocated.  The launch goes to the current stream and does not
    synchronise.  ``defines``: the macros of a build variant, e.g. a CTA
    tile from :func:`block_defines` (None: the default build; the plain
    version on the CPU has no tile).  ``cuda_ltl_step.launches`` counts
    kernel launches."""
    _check(packed, rule, boundary, gens, col_limit)
    if out is not None:
        check_out(out, packed, "K3")
    with recording("K3", packed, rule=rule, boundary=boundary, gens=gens,
                   col_limit=col_limit) as rec:
        if packed.device.type == "cpu":
            res = ltl_step_plain(packed, rule, boundary, gens, col_limit)
            out = res if out is None else out.copy_(res)
        else:
            check_cuda(packed, "K3")
            from mpi_tpu_torch.ops._build import load_rule_library

            if out is None:
                out = torch.empty_like(packed)
            launch(load_rule_library("ltl", rule, defines), packed, out,
                   rule, boundary, gens, col_limit)
            cuda_ltl_step.launches += 1
        rec.done(out)
    return out


def launch(lib, packed: torch.Tensor, out: torch.Tensor, rule: Rule,
           boundary: str, gens: int, col_limit: Optional[int] = None) -> None:
    """One pass of the K3 library ``lib`` (built for ``rule``) on the
    current stream; raises on a CUDA error.  Checks nothing else: callers
    are :func:`cuda_ltl_step` and timing scripts that compare builds."""
    B, H, NW = boards(packed)
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = lib.gol_ltl_step(packed.data_ptr(), out.data_ptr(), B, H, NW,
                               rule.radius, gens, int(boundary == "periodic"),
                               col_limit or 0, stream)
    raise_on_error(lib, err, "K3")


cuda_ltl_step.launches = 0
