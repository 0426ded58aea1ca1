"""Command line of the port, with the reference's positional contract
``rows cols iteration_gap iterations [time_file] [first]``.

Examples::

    python -m mpi_tpu_torch.cli 65536 65536 0 1000 --comm-every 8
    python -m mpi_tpu_torch.cli 16384 16384 0 300 --rule bosco --comm-every 3
    python -m mpi_tpu_torch.cli 512 512 10 50 --save --out-dir /tmp/run
    python -m mpi_tpu_torch.cli 512 512 10 50 --backend serial --save
    python -m mpi_tpu_torch.cli 64 64 10 50 --device cpu --resume NAME@50
    python -m mpi_tpu_torch.cli 65536 65536 0 1000 --sparse 128
    python -m mpi_tpu_torch.cli 2048 2048 10 50 --backend cpp-par --workers 8

``--backend cuda`` (the default) runs on the GPU through one of three
kernels (``backends/cuda.py:select_engine``): K1 for radius-1 rules, K3
for Larger-than-Life rules (radius 2..7) with ``--comm-every`` <= ⌊8/r⌋,
on a width of whole 32-cell words or padded to one (a periodic padded
width has its seam columns recomputed on a thin band, where the band
serves), and K2 for every other width or depth, in passes of at most
⌊16/r⌋ generations; ``--comm-every auto`` picks the depth
(``parallel/policy.py``); ``--sparse T`` steps only the T x T tiles that
can change (``ops/activity.py``); ``--device cpu`` runs the kernel's plain
PyTorch version instead.
``serial`` runs the numpy oracle, ``cpp`` the native C++ engine on one
host thread and ``cpp-par`` the same engine on a mesh of ``--workers``
host threads, one ``.gol`` tile per worker (``backends/cpp.py``).
Every backend writes the same ``.gol`` grids and the same two timing
reports; the master header counts the tile writers.
"""

from __future__ import annotations

import argparse
import os
import sys
import time as _time
from typing import List, Optional

from mpi_tpu_torch import golio
from mpi_tpu_torch.config import ConfigError, GolConfig, plan_segments
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.utils.timing import PhaseTimer, write_reports


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_tpu_torch",
        description="Game-of-Life / stencil engine on one NVIDIA GPU "
        "(PyTorch + hand-written CUDA), with a numpy serial oracle.",
    )
    p.add_argument("rows", type=int)
    p.add_argument("cols", type=int)
    p.add_argument("iteration_gap", type=int,
                   help="iterations between snapshots")
    p.add_argument("iterations", type=int)
    p.add_argument("time_file", nargs="?", default=None,
                   help="basename for timing reports (default: run name)")
    p.add_argument("first", nargs="?", type=int, default=0,
                   help="nonzero: write the CSV header (sweep convention)")
    p.add_argument("--backend", choices=["cuda", "serial", "cpp", "cpp-par"],
                   default="cuda")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda backend: cpu runs the kernel's plain PyTorch "
                   "version instead of the kernel")
    p.add_argument("--boundary", choices=["periodic", "dead"], default="periodic")
    p.add_argument("--rule", default="life",
                   help="life|highlife|seeds|daynight|bosco, B3/S23 syntax "
                   "or Larger-than-Life R5,B34-45,S33-57 syntax")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save", action="store_true",
                   help="write .gol snapshots every iteration_gap steps")
    p.add_argument("--snapshot-format", choices=["auto", "gol", "golp"],
                   default="auto",
                   help="gol = tab-separated text, golp = packed binary "
                   "(1 bit/cell); auto picks text up to %d cells per tile"
                   % golio.GOLP_THRESHOLD)
    p.add_argument("--out-dir", default=".")
    p.add_argument("--workers", type=int, default=0,
                   help="cpp-par worker threads (default: auto)")
    p.add_argument("--comm-every", default="1", metavar="K",
                   help="cuda backend: generations per kernel pass (1..16; "
                   "the dense kernel runs at most 16/radius a pass), the "
                   "kernel's temporal-blocking depth, or 'auto' to pick "
                   "it from the kernel the run lands on")
    p.add_argument("--sparse", type=int, default=0, metavar="T",
                   help="cuda backend: activity-gated sparse stepping with "
                   "TxT dirty tiles (ops/activity.py) — skip tiles that "
                   "provably cannot change (bit-identical; automatic "
                   "hysteresis fallback to dense when the board is busy). "
                   "T must divide the grid; multiple of 32 on the packed "
                   "engines. 0 = dense (default)")
    p.add_argument("--name", default=None, help="run name (default: timestamp)")
    p.add_argument("--strict", action="store_true",
                   help="enforce the reference's validation rules "
                   "(square grid, tile >= 4)")
    p.add_argument("--resume", default=None, metavar="NAME@ITER",
                   help="resume from snapshot ITER of run NAME; 'iterations' "
                   "then counts additional steps")
    p.add_argument("--quiet", action="store_true")
    return p


def _log(quiet: bool, msg: str) -> None:
    if not quiet:
        print(f"[mpi_tpu_torch] {msg}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except (ConfigError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _run(args) -> int:
    rule = rule_from_name(args.rule)
    auto_comm = args.comm_every == "auto"
    if auto_comm and args.backend != "cuda":
        raise ConfigError("--comm-every auto applies to the cuda backend only")
    try:
        comm_every = 1 if auto_comm else int(args.comm_every)
    except ValueError:
        raise ConfigError(
            f"--comm-every must be an integer or 'auto', got "
            f"{args.comm_every!r}"
        )
    config = GolConfig(
        rows=args.rows,
        cols=args.cols,
        steps=args.iterations,
        snapshot_every=args.iteration_gap if args.save else 0,
        seed=args.seed,
        rule=rule,
        boundary=args.boundary,
        backend=args.backend,
        workers=args.workers,
        comm_every=comm_every,
        sparse_tile=args.sparse,
    )
    if auto_comm:
        import dataclasses

        from mpi_tpu_torch.parallel.policy import resolve_auto

        config = dataclasses.replace(config, comm_every=resolve_auto(config))
        _log(args.quiet, f"comm policy auto: comm_every={config.comm_every}")
    if args.strict:
        # backend-independent checks fail here, before any side effect;
        # the cpp-par tile plan is judged below
        config.validate_strict()
    # processes in the master header = number of tile writers: one device
    # (cuda) or one process (serial, cpp), or the cpp-par tile mesh
    tiles_shape = (1, 1)
    if config.backend == "cpp-par":
        from mpi_tpu_torch.backends.cpp import plan_tiles

        tiles_shape = plan_tiles((config.rows, config.cols), config.workers,
                                 rule.radius)
        if args.strict:
            config.validate_strict(tiles_shape)
    processes = tiles_shape[0] * tiles_shape[1]
    if config.backend == "cuda":
        from mpi_tpu_torch.backends.cuda import resolve_device

        resolve_device(args.device)  # fail before any file is written

    os.makedirs(args.out_dir, exist_ok=True)
    name = args.name or _time.strftime("%Y-%m-%d-%H-%M-%S")
    timer = PhaseTimer()

    initial = None
    start_iter = 0
    if args.resume:
        try:
            rname, riter = args.resume.rsplit("@", 1)
            start_iter = int(riter)
        except ValueError:
            raise ConfigError(f"--resume must look like NAME@ITER, got {args.resume!r}")
        try:
            srows, scols, _, _, _ = golio.read_master(
                golio.master_path(args.out_dir, rname))
            if (srows, scols) != (config.rows, config.cols):
                raise ConfigError(
                    f"snapshot {rname}@{start_iter} is {(srows, scols)}, "
                    f"run asks for {(config.rows, config.cols)}"
                )
            initial = golio.load_snapshot(args.out_dir, rname, start_iter)
        except FileNotFoundError as e:
            raise ConfigError(f"cannot resume {args.resume!r}: {e}")
        name = args.name or rname
        _log(args.quiet, f"resumed {rname}@{start_iter}")

    total_iter = start_iter + config.steps
    golio.write_master(
        args.out_dir, name, config.rows, config.cols,
        args.iteration_gap, total_iter, processes,
    )
    _log(args.quiet, f"run {name}: {config.rows}x{config.cols} x{config.steps} steps, "
         f"rule={rule}, boundary={config.boundary}, backend={config.backend}, "
         f"device={args.device if config.backend == 'cuda' else 'host'}")

    def snapshot(iteration, tiles) -> None:
        golio.write_snapshot_tiles(
            args.out_dir, name, iteration,
            [(tile, r0, c0) for _pid, tile, r0, c0 in tiles],
            fmt=args.snapshot_format)

    def host_snapshot(grid, iteration) -> None:
        ti, tj = tiles_shape
        tr, tc = grid.shape[0] // ti, grid.shape[1] // tj
        snapshot(iteration, [
            (i * tj + j, grid[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc],
             i * tr, j * tc)
            for i in range(ti) for j in range(tj)])

    if config.backend == "cuda":
        from mpi_tpu_torch.backends.cuda import run_cuda

        final = run_cuda(
            config,
            timer=timer,
            snapshot_cb=snapshot if args.save else None,
            initial=initial,
            start_iteration=start_iter,
            device=args.device,
        )
    else:
        if config.backend == "serial":
            from mpi_tpu_torch.backends.serial_np import evolve_np

            def engine(g, n):
                return evolve_np(g, n, rule, config.boundary)
        else:
            from mpi_tpu_torch.backends.cpp import (
                evolve_cpp, evolve_par_cpp, load_library,
            )

            # building/loading the native library is setup, like the
            # kernels' build and warm-up
            load_library()
            if config.backend == "cpp":
                def engine(g, n):
                    return evolve_cpp(g, n, rule, config.boundary)
            else:
                def engine(g, n):
                    return evolve_par_cpp(g, n, rule, config.boundary,
                                          tiles=tiles_shape)
        from mpi_tpu_torch.utils.hashinit import init_tile_np

        grid = (init_tile_np(config.rows, config.cols, config.seed)
                if initial is None else initial)
        timer.setup_done()
        it = start_iter
        if args.save and it == 0:
            host_snapshot(grid, 0)
        for n in plan_segments(config.steps, config.snapshot_every):
            grid = engine(grid, n)
            it += n
            if args.save:
                host_snapshot(grid, it)
        timer.finish()
        final = grid

    write_reports(
        args.time_file or name, timer, config.rows, config.cols, processes,
        first=bool(args.first), out_dir=args.out_dir,
    )
    cps = timer.cells_per_sec(config.rows, config.cols, config.steps)
    _log(args.quiet,
         f"done: setup {timer.setup_us / 1e6:.2f}s, steady {timer.nosetup_us / 1e6:.2f}s, "
         f"{cps / 1e9:.3f} G cell-updates/s; population {int(final.sum(dtype='int64'))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
