"""Three-phase timing and the two report files, in the formats of
``mpi_tpu.utils.timing``.

``start → [setup] → setup_done → [steady] → finish``.  On the cuda backend
"setup" is grid init plus the kernel build and warm-up; "nosetup" is the
steady stepping that throughput is derived from.  The reports are the
human-readable ``<name>_detailed.out`` and the 12-column
``<name>_compact.csv`` (``X,Y,#P,{full,nosetup,setup}×{single,avg,sum}``,
microseconds).  In one process each device's time is the wall time:
single == avg, sum = wall × P.  Under a process group
(``parallel/dist.py``, ``--multihost``) the avg and sum columns come from
every process's durations (:func:`gather_process_durations`), the
reference's ``MPI_Reduce(MPI_SUM)`` of per-rank times.
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


def gather_process_durations(timer: PhaseTimer):
    """Every process's ``[full, nosetup, setup]`` µs, a (P, 3) int64 array
    allgathered across the process group (the reference's three
    ``MPI_Reduce(MPI_SUM)`` of per-rank durations, as an allgather so any
    process could report).  None outside a group of more than one
    process.  Collective: under a group every process must call it."""
    from mpi_tpu_torch.parallel import dist

    if dist.process_count() == 1:
        return None
    import numpy as np

    return dist.process_allgather(np.array(
        [timer.full_us, timer.nosetup_us, timer.setup_us], dtype=np.int64))


def write_reports(
    time_file: str,
    timer: PhaseTimer,
    rows: int,
    cols: int,
    processes: int,
    first: bool = False,
    out_dir: str = ".",
    all_durations=None,
    extra=None,
) -> None:
    """Append the pair of reports; ``first`` writes the CSV header.

    ``processes`` is the tile-writer count reported in the #P column.
    ``all_durations``, a (P_proc, 3) array of per-process ``[full,
    nosetup, setup]`` µs from :func:`gather_process_durations`, feeds the
    avg and sum columns as the reference's ``MPI_Reduce`` did (single =
    process 0's time); without it each device's time is the wall time.
    ``extra``: an ordered mapping of column name → value appended after
    the 12 CSV columns (and to the header), as the reference's sweeps
    add them; without it the rows are exactly the reference schema's."""
    p = max(processes, 1)
    if all_durations is not None:
        import numpy as np

        a = np.asarray(all_durations, dtype=np.int64)
        sums = a.sum(axis=0)
        triples = list(zip(a[0].tolist(), (sums // a.shape[0]).tolist(),
                           sums.tolist()))
    else:
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
            if extra:
                f.write(CSV_HEADER.rstrip("\n")
                        + "".join(f",{k}" for k in extra) + "\n")
            else:
                f.write(CSV_HEADER)
        row = (
            f"{rows},{cols},{p},{full},{full_a},{full_s},"
            f"{nos},{nos_a},{nos_s},{setup},{setup_a},{setup_s}"
        )
        if extra:
            row += "".join(f",{v}" for v in extra.values())
        f.write(row + "\n")
        f.flush()
        os.fsync(f.fileno())
