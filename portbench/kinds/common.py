"""What the traffic kinds share: their outcome, the program's configuration made
from the benchmark's, and the wait that closes a timed region."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from portbench.reference.cells import port_rule_text


@dataclass
class Outcome:
    """One run of a cell: its end-to-end numbers by metric name, the
    answers attempted and failed, each number compared with its limit
    ``(name, value, limit)``, the program's memory peak, the traced window
    (None untraced), the work that the per-layer readers divide, the
    seconds of the window, of the check and of each phase of set-up
    (from the process's start to each phase's end), and the card's
    readings in the window's middle."""

    e2e: dict
    attempted: int
    failed: int
    checks: List[Tuple[str, float, float]]
    memory_peak_bytes: int
    trace: Optional[object] = None
    work: dict = field(default_factory=dict)
    window_s: float = 0.0
    check_s: float = 0.0
    setup_phases: dict = field(default_factory=dict)
    under_load: dict = field(default_factory=dict)


def port_config(ctx, rows: int, cols: int):
    """The program's run configuration for a board of ``rows`` x ``cols``
    under the cell's configuration."""
    from mpi_tpu_torch.config import GolConfig
    from mpi_tpu_torch.models.rules import rule_from_name

    return GolConfig(rows=rows, cols=cols, steps=0,
                     rule=rule_from_name(port_rule_text(ctx.rule)),
                     boundary=ctx.config["boundary"],
                     comm_every=ctx.config["comm_every"])


def sync(dev) -> None:
    """Wait for the card (nothing on the CPU)."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class Phases:
    """Set-up's phases, each timed from the process's start to its end:
    the caller's ``ctx.marks``, then the program's imports, then each
    :meth:`mark`."""

    def __init__(self, ctx):
        self.t0 = ctx.t0
        self.ends = dict(ctx.marks)
        self.mark("import_program")

    def mark(self, name: str) -> None:
        self.ends[name] = time.perf_counter() - self.t0
