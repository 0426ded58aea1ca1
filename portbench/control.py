"""The check's control and its planted faults: the program's stepping
replaced underneath a run, so that ``correct`` has to come out false.

* ``control``: the plain reference in the program's place, with one
  guarantee of the configuration broken: a dead boundary where the
  configuration states a torus (the system runs no model and states no
  precision, so it is a guarantee that the control breaks);
* ``unchanged``: a step that returns its state unchanged;
* ``half_batch``: a batched step that leaves the second half of its
  boards unstepped;
* ``flip``: one cell of each step's output flipped where it is produced.

No run of the benchmark plants any of them.  To read the control (or a
fault) on the card at a cell's own size, on several seeds in one process:

    python3 -m portbench.control --workload life.run --seeds 1 2 3

It prints one line a seed with the numbers compared.  The window is
short (``--seconds``, default 2) and set-up takes one warm-up pass or
request: the reference in the program's place is far slower than it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

FAULTS = ("control", "unchanged", "half_batch", "flip")


@contextlib.contextmanager
def planted(fault: str, rule):
    """Every engine's ``step`` and ``step_batched`` replaced by ``fault``
    for the ``with`` block; ``rule`` is the reference's parsed rule."""
    from mpi_tpu_torch.backends.cuda import Engine

    from portbench.reference.cells import evolve_packed

    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}, got {fault!r}")
    saved = Engine.step, Engine.step_batched

    def wrap(orig, batched: bool):
        def step(self, grid, n):
            if fault == "unchanged":
                return grid
            if fault == "control":
                return evolve_packed(grid, rule, n, self.config.cols, "dead")
            keep = None
            if fault == "half_batch" and batched:
                keep = grid[grid.shape[0] // 2:].clone()
            out = orig(self, grid, n)
            if keep is not None:
                out[out.shape[0] - keep.shape[0]:] = keep
            if fault == "flip":
                flat = out.view(-1)
                flat[0] = flat[0] ^ 1
            return out
        return step

    Engine.step = wrap(saved[0], False)
    Engine.step_batched = wrap(saved[1], True)
    try:
        yield
    finally:
        Engine.step, Engine.step_batched = saved


def quick_traffic(traffic: dict) -> dict:
    """The cell's traffic at its own sizes with the least set-up: one
    warm-up pass or request, one timed."""
    out = dict(traffic)
    if out["kind"] == "run":
        out.update(warmup_passes=1, timing_passes=1)
    else:
        out.update(warmup_requests=2)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", choices=FAULTS, default="control")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    from portbench import harness
    from portbench.reference.cells import parse_rule

    manifest = harness.load_manifest()
    cell = harness.cell_entry(manifest, args.workload)
    rule = parse_rule(harness.config_file(manifest, cell["config"])["rule"])
    traffic = quick_traffic(harness.traffic_file(cell["traffic"]))
    for seed in args.seeds:
        t0 = time.perf_counter()
        with planted(args.fault, rule):
            r = harness.run_cell(args.workload, seed, args.seconds, False,
                                 t0=t0, traffic=traffic, manifest=manifest)
        print(json.dumps({"workload": args.workload, "fault": args.fault,
                          "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "seconds": time.perf_counter() - t0,
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
