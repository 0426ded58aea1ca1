"""Three-phase timing and the two report files, in the formats of
``mpi_tpu.utils.timing``.

``start → [setup] → setup_done → [steady] → finish``.  On the cuda backend
"setup" is grid init plus the kernel build and warm-up; "nosetup" is the
steady stepping that throughput is derived from.  The reports are the
human-readable ``<name>_detailed.out`` and the 12-column
``<name>_compact.csv`` (``X,Y,#P,{full,nosetup,setup}×{single,avg,sum}``,
microseconds).  The port runs one process, so each device's time is the
wall time: single == avg, sum = wall × P.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field

CSV_HEADER = (
    "X,Y,#P,full single,full avg,full sum,nosetup single,nosetup avg,"
    "nosetup sum,setup single ,setup avg ,setup sum \n"
)


@dataclass
class PhaseTimer:
    """start() → [setup work] → setup_done() → [steady work] → finish().

    ``span_sink``: optional ``callable(phase, t_start, dur_s)`` invoked at
    ``finish()`` with the two phases ("setup", "steady") —
    ``mpi_tpu_torch.obs.Obs.phase_sink`` turns them into trace events."""

    t_begin: float = field(default_factory=time.perf_counter)
    t_setup_done: float = 0.0
    t_end: float = 0.0
    span_sink: object = None

    def setup_done(self) -> None:
        self.t_setup_done = time.perf_counter()

    def finish(self) -> None:
        self.t_end = time.perf_counter()
        if self.t_setup_done == 0.0:
            self.t_setup_done = self.t_begin
        if self.span_sink is not None:
            self.span_sink("setup", self.t_begin,
                           self.t_setup_done - self.t_begin)
            self.span_sink("steady", self.t_setup_done,
                           self.t_end - self.t_setup_done)

    @property
    def full_us(self) -> int:
        return int((self.t_end - self.t_begin) * 1e6)

    @property
    def setup_us(self) -> int:
        return int((self.t_setup_done - self.t_begin) * 1e6)

    @property
    def nosetup_us(self) -> int:
        return int((self.t_end - self.t_setup_done) * 1e6)

    def cells_per_sec(self, rows: int, cols: int, iters: int) -> float:
        ns = self.nosetup_us
        return rows * cols * iters / (ns / 1e6) if ns > 0 else 0.0


def write_reports(
    time_file: str,
    timer: PhaseTimer,
    rows: int,
    cols: int,
    processes: int,
    first: bool = False,
    out_dir: str = ".",
) -> None:
    """Append the pair of reports; ``first`` writes the CSV header."""
    p = max(processes, 1)
    triples = [
        (d, d, d * p)
        for d in (timer.full_us, timer.nosetup_us, timer.setup_us)
    ]
    (full, full_a, full_s), (nos, nos_a, nos_s), (setup, setup_a, setup_s) = triples
    detailed = os.path.join(out_dir, f"{time_file}_detailed.out")
    with open(detailed, "a") as f:
        f.write("Timing results: microseconds\n")
        f.write(f"size:{rows} by {cols}\n")
        f.write(f"{p} Processors\n")
        for label, (single, avg, total) in zip(
            ("Full (with setup)", "Without setup", "Setup"), triples
        ):
            f.write(f"{label}\n")
            f.write(f"Single time (rank 0): {single}us\n")
            f.write(f"Avg single time: {avg}us\n")
            f.write(f"Summed time: {total}us\n")
        f.write(f"Throughput: {timer.cells_per_sec(rows, cols, 1):.0f} cells/sec/iter-unit\n")
        f.write("___________________________________________________\n\n")
        # a sweep that dies mid-run keeps the rows already written
        f.flush()
        os.fsync(f.fileno())
    compact = os.path.join(out_dir, f"{time_file}_compact.csv")
    with open(compact, "a") as f:
        if first:
            f.write(CSV_HEADER)
        f.write(
            f"{rows},{cols},{p},{full},{full_a},{full_s},"
            f"{nos},{nos_a},{nos_s},{setup},{setup_a},{setup_s}\n"
        )
        f.flush()
        os.fsync(f.fileno())
