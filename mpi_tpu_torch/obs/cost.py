"""Cost cards: the arithmetic and memory price of one step of an engine,
counted from the kernels' own instruction counts.

When an :class:`~mpi_tpu_torch.backends.cuda.Engine` warms a step depth
for the first time (``ensure_compiled``/``ensure_compiled_batched``, a
real miss under its ``_compile_lock``) with observability on, it captures
one :class:`CostCard` per (depth, B).  The engine IS the plan signature
(one engine per ``config.plan_signature``), so the engine owns its cards
and the ledger and ``SessionManager.usage`` join them back to signature
rows at read time.

The counts are the kernels', ``source = "kernel_count"``:

* K1 (``csrc/bitlife.cu``): ``ops/bitlife.py:word_ops(rule)`` LOP3 and SHF
  instructions per word per generation (the rule's compiled form), times
  words, generations and boards;
* K3 (``csrc/bitltl.cu``): ``ops/bitltl.py:ltl_word_ops(rule,
  "row_first")``, the order the kernel sums in, the same way;
* K2 (``csrc/stencil.cu``): ``ops/stencil.py:dense_cell_ops(r)``
  instructions per cell per generation, counted from the kernel's row
  loop, times cells, generations and boards; a padded periodic engine adds
  its seam band's work, which its one launch (``seam_band_kernel``) does
  with K2's row loop.

A sparse engine's card counts the dense work of the same depth: the work
it skips depends on the board, so the card is its upper bound.  Bytes are
one read and one write of the board (or batch) per kernel pass;
``peak_memory_bytes`` is the grid and its spare, the engine's ping-pong
pair.  XLA's ``cost_analysis`` and the reference's jaxpr op count
(``mpi_tpu/obs/opcount.py``) have no counterpart here: the port has no
compiled program to ask, and its kernels' counts are exact for the forms
they run.

``flops`` keeps the reference's field name; here it counts int32
instructions, the currency of :func:`roof_ops_per_s`.
"""

from __future__ import annotations

import functools
import os
from dataclasses import asdict, dataclass
from typing import Optional

# int32 lanes per SM by compute capability major (Volta, Ampere, Hopper:
# 64 of an SM's lanes execute int32 instructions)
INT32_LANES_PER_SM = {7: 64, 8: 64, 9: 64}


@functools.lru_cache(maxsize=None)
def device_roof_ops_per_s(index: int = 0) -> Optional[float]:
    """The card's int32 instruction rate: SM count x int32 lanes per SM x
    SM clock (``clock_rate``, kHz), from
    ``torch.cuda.get_device_properties(index)`` (for an H100 SXM: 132 x 64
    x 1.98 GHz = 16.7e12 instructions/s).  None off the card, or for an
    architecture the table does not know."""
    import torch

    if not torch.cuda.is_available():
        return None
    props = torch.cuda.get_device_properties(index)
    lanes = INT32_LANES_PER_SM.get(props.major)
    khz = getattr(props, "clock_rate", 0)   # cudaDeviceProp.clockRate
    if lanes is None or not khz:
        return None
    return float(props.multi_processor_count * lanes * khz * 1e3)


# the roof off the card (or on an architecture missing from
# INT32_LANES_PER_SM): the int32 rate chip_smoke.py phase 7 read on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, 132 SMs x 64 lanes x
# 1.98 GHz.  A CPU readout then reads as a fraction of that card's roof.
DEFAULT_ROOF_OPS_PER_S = 16727040000000.0


def roof_ops_per_s() -> float:
    """The ops/s roof the live roofline-efficiency readout divides by:
    ``MPI_TPU_ROOF_OPS_PER_S`` when set (a roof measured for THIS box),
    else the card's int32 instruction rate (:func:`device_roof_ops_per_s`),
    else :data:`DEFAULT_ROOF_OPS_PER_S`."""
    raw = os.environ.get("MPI_TPU_ROOF_OPS_PER_S")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    roof = device_roof_ops_per_s()
    return roof if roof is not None else DEFAULT_ROOF_OPS_PER_S


@dataclass(frozen=True)
class CostCard:
    """The arithmetic price of ONE execution of an engine's step."""

    sig_label: str              # compact plan tag (serve/cache.signature_label)
    depth: int                  # generations advanced per execution (n)
    batch: int                  # stacked boards (B); 0 = the solo step
    flops: float                # int32 instructions (see the module doc)
    bytes_accessed: float       # device bytes read and written
    peak_memory_bytes: float    # the grid(s) and their spare
    code_size_bytes: float      # 0: not reported
    source: str                 # "kernel_count"

    @property
    def boards(self) -> int:
        """Boards advanced per execution (the solo step runs 1)."""
        return self.batch if self.batch else 1

    def ops_per_cell(self, cells: int) -> float:
        """flops normalized per cell-update of one execution."""
        denom = float(cells) * max(self.depth, 1) * self.boards
        return self.flops / denom if denom else 0.0

    def as_dict(self) -> dict:
        return asdict(self)


def ops_per_cell_detail(cards, cells: int):
    """``(estimate, trip_count_suspect)`` for one signature's captured
    cards, the reference's readout: depth-1 cards are preferred, and an
    estimate from deeper cards alone is flagged.  The kernel counts are
    exact per depth, so the flag here only says that no depth-1 card was
    captured.  ``(None, False)`` when no card carries ops."""
    vals = [c.ops_per_cell(cells) for c in cards if c.flops > 0]
    depth1 = [c.ops_per_cell(cells) for c in cards
              if c.flops > 0 and c.depth == 1]
    if depth1:
        return min(depth1), False
    if vals:
        return min(vals), True
    return None, False


def ops_per_cell_estimate(cards, cells: int):
    """The bare estimate (see :func:`ops_per_cell_detail`)."""
    return ops_per_cell_detail(cards, cells)[0]


def capture_card(engine, *, depth: int, batch: int) -> CostCard:
    """The card of ``engine`` stepping ``depth`` generations of one board
    (``batch`` 0) or of a stacked batch of ``batch`` boards, from its
    kernel's count (see the module doc)."""
    from mpi_tpu_torch.backends.cuda import WORD
    from mpi_tpu_torch.ops.stencil import dense_cell_ops

    config = engine.config
    rule, rows = config.rule, config.rows
    boards = batch if batch else 1
    if engine.kind == "bit":
        from mpi_tpu_torch.ops.bitlife import word_ops

        units, per_unit = rows * engine.cols_eff // WORD, word_ops(rule)
        board_bytes = 4 * units
    elif engine.kind == "ltl":
        from mpi_tpu_torch.ops.bitltl import ltl_word_ops

        units = rows * engine.cols_eff // WORD
        per_unit = ltl_word_ops(rule, "row_first")
        board_bytes = 4 * units
    else:
        units, per_unit = config.cells, dense_cell_ops(rule.radius)
        board_bytes = units
    # the passes segmented_evolve runs: full passes of k, then the rest
    k = max(1, min(engine.depth, depth))
    passes = [k] * (depth // k) + ([depth % k] if depth % k else [])
    ops = float(per_unit) * units * depth
    moved = 2.0 * board_bytes * len(passes)
    if engine.seam:
        # the seam band: 4 k r columns of every row, stepped k generations
        # with K2's row loop once a pass
        for kp in passes:
            band = rows * 4 * kp * rule.radius
            ops += float(dense_cell_ops(rule.radius)) * band * kp
            moved += 2.0 * band
    return CostCard(sig_label=engine.sig_label or "unkeyed", depth=int(depth),
                    batch=int(batch), flops=ops * boards,
                    bytes_accessed=moved * boards,
                    peak_memory_bytes=2.0 * board_bytes * boards,
                    code_size_bytes=0.0, source="kernel_count")
