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
    python -m mpi_tpu_torch.cli 4096 4096 0 64 --profile /tmp/trace
    python -m mpi_tpu_torch.cli 256 256 8 16 --device cpu --mesh 2x4 --save
    python -m mpi_tpu_torch.cli 64 256 16 16 --mesh 2x2 --save --multihost \
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0
    python -m mpi_tpu_torch.cli serve --port 8000   # sessions over HTTP

``--backend cuda`` (the default) runs on the GPU through one of three
kernels (``backends/cuda.py:select_engine``): K1 for radius-1 rules, K3
for Larger-than-Life rules (radius 2..7) with ``--comm-every`` <= ⌊8/r⌋,
on a width of whole 32-cell words or padded to one (a periodic padded
width has its seam columns recomputed on a thin band, where the band
serves), and K2 for every other width or depth, in passes of at most
⌊16/r⌋ generations; ``--comm-every auto`` picks the depth
(``parallel/policy.py``); ``--sparse T`` steps only the T x T tiles that
can change (``ops/activity.py``); ``--device cpu`` runs the kernel's plain
PyTorch version instead; ``--profile DIR`` writes one Chrome trace of the
run (``torch.profiler``, the host and the card) into DIR.
``--mesh IxJ`` shards the grid over a device mesh driven by this one
process (``parallel/mesh.py``, ``backends/cuda_mesh.py``), one ``.gol``
tile a shard; on the card it must use every card, as the reference's does
(one card: only ``1x1``), and with ``--device cpu`` it runs on up to 8
virtual CPU devices; ``--overlap`` asks for the stitched-band body.
Without ``--mesh`` the run takes one device (the reference takes every
device it sees).
``--multihost`` joins a process group of ``--num-processes`` ranks
(``parallel/dist.py``; the reference's ``mpirun -np N``): launch one
process a rank, each with its ``--process-id``, all with one
``--coordinator HOST:PORT`` (or none: ``MASTER_ADDR``, ``MASTER_PORT``,
``WORLD_SIZE`` and ``RANK`` from the environment).  The mesh then spans
the ranks (without ``--mesh``, one device a rank), each rank writes its
own shards' tiles and, on ``--resume``, reads only the regions of its
shards; process 0 alone writes the timing reports, whose avg and sum
columns gather every process's durations.  The run is named from the
config (``run-{rows}x{cols}-{iterations}-s{seed}``) unless ``--name``.
``serial`` runs the numpy oracle, ``cpp`` the native C++ engine on one
host thread and ``cpp-par`` the same engine on a mesh of ``--workers``
host threads, one ``.gol`` tile per worker (``backends/cpp.py``).
Every backend writes the same ``.gol`` grids and the same two timing
reports; the master header counts the tile writers.

``serve`` runs the session service over HTTP instead
(``serve/cli.py:serve_main``; ``serve --help`` lists its flags).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time as _time
from typing import List, Optional, Tuple

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
    p.add_argument("--mesh", default=None, metavar="IxJ",
                   help="cuda backend: device mesh shape, e.g. 2x4 (default: "
                   "one device); on the card it must use every card, with "
                   "--device cpu up to 8 virtual devices")
    p.add_argument("--overlap", action="store_true",
                   help="cuda backend on a mesh: step each tile's interior "
                   "from its own data and recompute only the halo-deep "
                   "edge bands from the exchange (stitched-band body)")
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
    p.add_argument("--multihost", action="store_true",
                   help="join a process group through torch.distributed "
                   "(launch one process per rank; the mpirun analog, "
                   "reference gol.pbs): the mesh spans the ranks")
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="multihost coordinator address (default: "
                   "MASTER_ADDR, MASTER_PORT, WORLD_SIZE and RANK from the "
                   "environment)")
    p.add_argument("--num-processes", type=int, default=None,
                   help="multihost process-group size (with --coordinator)")
    p.add_argument("--process-id", type=int, default=None,
                   help="this process's rank in the group (with --coordinator)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="cuda backend: capture a torch.profiler trace of "
                   "the run (CPU activity, and the card's with --device "
                   "cuda) into DIR as one Chrome trace, "
                   "trace-<pid>-<ns>.json (trace-r<rank>-<pid>-<ns>.json "
                   "under --multihost, one a rank)")
    p.add_argument("--quiet", action="store_true")
    return p


@contextlib.contextmanager
def profile_run(logdir: str, device: str, rank: Optional[int] = None):
    """``torch.profiler`` around the body, exported into ``logdir`` as one
    Chrome trace named as ``obs/profile.py:run_profile`` names its
    captures (``trace-<pid>-<ns>.json``; ``trace-r<rank>-<pid>-<ns>.json``
    for a rank of a process group).  On the card the trace must hold the
    card's activity: a profiler without CUDA activity raises rather than
    write a trace of the host alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device == "cuda":
        if ProfilerActivity.CUDA not in torch.profiler.supported_activities():
            raise RuntimeError(
                "--profile on the card: this torch.profiler has no CUDA "
                "activity, so the trace would hold the host alone")
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    who = f"r{rank}-" if rank is not None else ""
    path = os.path.join(logdir,
                        f"trace-{who}{os.getpid()}-{_time.time_ns()}.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


def _parse_mesh(s: Optional[str]) -> Optional[Tuple[int, int]]:
    if s is None:
        return None
    try:
        a, b = s.lower().split("x")
        return int(a), int(b)
    except ValueError:
        raise ConfigError(f"--mesh must look like 2x4, got {s!r}")


def _log(quiet: bool, msg: str) -> None:
    if not quiet:
        print(f"[mpi_tpu_torch] {msg}", flush=True)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] == "serve":
        # subcommand dispatch ahead of the positional-args parser (which
        # would read "serve" as rows); the one-shot contract is untouched
        from mpi_tpu_torch.serve.cli import serve_main

        return serve_main(argv[1:])
    args = build_parser().parse_args(argv)
    try:
        return _run(args)
    except (ConfigError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


def _run(args) -> int:
    if not args.multihost:
        return _run_one(args, None)
    if args.backend != "cuda":
        # the process group is the device mesh's; the host backends are
        # single-process by construction
        raise ConfigError(
            f"--multihost applies to the cuda backend only "
            f"(got backend={args.backend!r})")
    if args.coordinator is None and (args.num_processes is not None
                                     or args.process_id is not None):
        raise ConfigError("--num-processes and --process-id go with "
                          "--coordinator")
    from mpi_tpu_torch.parallel import dist

    # before any other CUDA call: the placement picks this rank's card
    group = dist.initialize(args.coordinator, args.num_processes,
                            args.process_id, device=args.device)
    try:
        _log(args.quiet, f"multihost: {group.describe()}")
        rc = _run_one(args, group)
        st = group.stats
        _log(args.quiet,
             f"multihost: {st['exchanges']} exchanges, {st['messages']} "
             f"messages, {st['bytes_sent']} bytes sent, "
             f"{st['bytes_staged']} bytes staged through the host, "
             f"{st['sync_us']} us in stream syncs, {st['wait_us']} us in "
             f"waits")
        return rc
    finally:
        # every exit path, errors included: a failed rank never leaves the
        # others waiting
        dist.shutdown()


def _run_one(args, group) -> int:
    """One run; ``group``: the process group this rank belongs to."""
    rule = rule_from_name(args.rule)
    mesh_shape = _parse_mesh(args.mesh)
    auto_comm = args.comm_every == "auto"
    if args.profile and args.backend != "cuda":
        raise ConfigError(
            f"--profile traces the cuda backend's run, not --backend "
            f"{args.backend}")
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
        mesh_shape=mesh_shape,
        workers=args.workers,
        comm_every=comm_every,
        overlap=args.overlap,
        sparse_tile=args.sparse,
    )
    if args.strict:
        # backend-independent checks (square grid, a typed --mesh) fail
        # here, before any side effect; the tile plan is judged below
        config.validate_strict()
    # processes in the master header = number of tile writers: the device
    # mesh (cuda; one device without --mesh) or one process (serial, cpp),
    # or the cpp-par tile mesh
    tiles_shape = (1, 1)
    mesh = None
    if config.backend == "cuda":
        from mpi_tpu_torch.backends.cuda import resolve_device

        resolve_device(args.device)  # fail before any file is written
        tiles_shape = mesh_shape or (1, 1)
        if group is not None:
            import dataclasses

            from mpi_tpu_torch.config import validate_mesh
            from mpi_tpu_torch.parallel.mesh import choose_mesh_shape

            # the world mesh: one device a rank without --mesh
            tiles_shape = mesh_shape or choose_mesh_shape(group.size)
            validate_mesh(config.rows, config.cols, tiles_shape,
                          rule.radius * config.comm_every,
                          processes=group.size)
            if config.sparse_tile:
                raise ConfigError(
                    f"sparse_tile requires a single-device mesh (got "
                    f"{tiles_shape[0]}x{tiles_shape[1]}); shard OR "
                    f"activity-gate, not both yet")
            config = dataclasses.replace(config, mesh_shape=tiles_shape)
        if tiles_shape[0] * tiles_shape[1] > 1:
            from mpi_tpu_torch.parallel.mesh import make_mesh

            mesh = make_mesh(tiles_shape, platform=args.device)
    if auto_comm:
        import dataclasses

        from mpi_tpu_torch.parallel.policy import resolve_auto

        if mesh is None:
            config = dataclasses.replace(config,
                                         comm_every=resolve_auto(config))
            _log(args.quiet,
                 f"comm policy auto: comm_every={config.comm_every}")
        else:
            k, ov = resolve_auto(config, tiles_shape, mesh=mesh)
            config = dataclasses.replace(config, comm_every=k,
                                         overlap=ov or config.overlap)
            _log(args.quiet, f"comm policy auto: comm_every={k}, "
                 f"overlap={config.overlap}")
    if config.backend == "cpp-par":
        from mpi_tpu_torch.backends.cpp import plan_tiles

        tiles_shape = plan_tiles((config.rows, config.cols), config.workers,
                                 rule.radius)
    if args.strict:
        # judged against the decomposition that will run
        config.validate_strict(tiles_shape)
    processes = tiles_shape[0] * tiles_shape[1]

    os.makedirs(args.out_dir, exist_ok=True)
    if args.name:
        name = args.name
    elif group is not None:
        # the ranks' clocks can straddle a second: one name from the config
        name = f"run-{args.rows}x{args.cols}-{args.iterations}-s{args.seed}"
    else:
        name = _time.strftime("%Y-%m-%d-%H-%M-%S")
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
            if group is None:
                initial = golio.load_snapshot(args.out_dir, rname, start_iter)
            else:
                # no rank reads the whole grid: the engine calls this once
                # for each shard the rank holds, which reads only the tile
                # files that meet the shard
                def initial(r0, r1, c0, c1, _rn=rname, _it=start_iter):
                    return golio.assemble_region(args.out_dir, _rn, _it,
                                                 r0, r1, c0, c1)
        except FileNotFoundError as e:
            raise ConfigError(f"cannot resume {args.resume!r}: {e}")
        name = args.name or rname
        _log(args.quiet, f"resumed {rname}@{start_iter}")

    total_iter = start_iter + config.steps
    # every rank writes the master file (one content, an atomic write), so
    # that each one's disk holds it for a resume; only the timing reports
    # below have one writer
    golio.write_master(
        args.out_dir, name, config.rows, config.cols,
        args.iteration_gap, total_iter, processes,
    )
    _log(args.quiet, f"run {name}: {config.rows}x{config.cols} x{config.steps} steps, "
         f"rule={rule}, boundary={config.boundary}, backend={config.backend}, "
         f"device={args.device if config.backend == 'cuda' else 'host'}")

    def snapshot(iteration, tiles) -> None:
        # each tile under its own pid (a mesh's shard wholly in the pad
        # writes none; each rank of a group writes its own shards'); then
        # every pid outside the writer set goes
        for pid, tile, r0, c0 in tiles:
            golio.write_tile_fmt(args.out_dir, name, iteration, pid, tile,
                                 r0, c0, fmt=args.snapshot_format)
        golio.remove_stale_tiles(args.out_dir, name, iteration,
                                 range(processes))

    def host_snapshot(grid, iteration) -> None:
        ti, tj = tiles_shape
        tr, tc = grid.shape[0] // ti, grid.shape[1] // tj
        snapshot(iteration, [
            (i * tj + j, grid[i * tr:(i + 1) * tr, j * tc:(j + 1) * tc],
             i * tr, j * tc)
            for i in range(ti) for j in range(tj)])

    if config.backend == "cuda":
        from mpi_tpu_torch.backends.cuda import run_cuda

        profile_ctx = contextlib.nullcontext()
        if args.profile:
            profile_ctx = profile_run(
                args.profile, args.device,
                rank=None if group is None else group.rank)
        with profile_ctx as trace_path:
            final = run_cuda(
                config,
                timer=timer,
                snapshot_cb=snapshot if args.save else None,
                initial=initial,
                start_iteration=start_iter,
                device=args.device,
                mesh=mesh,
            )
        if trace_path:
            _log(args.quiet, f"profile: {trace_path}")
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

    all_durations = None
    if group is not None:
        from mpi_tpu_torch.utils.timing import gather_process_durations

        # collective: every rank takes part, process 0 alone reports
        all_durations = gather_process_durations(timer)
    if group is None or group.rank == 0:
        write_reports(
            args.time_file or name, timer, config.rows, config.cols,
            processes, first=bool(args.first), out_dir=args.out_dir,
            all_durations=all_durations,
        )
    cps = timer.cells_per_sec(config.rows, config.cols, config.steps)
    population = ("n/a (multihost)" if final is None
                  else int(final.sum(dtype="int64")))
    _log(args.quiet,
         f"done: setup {timer.setup_us / 1e6:.2f}s, steady {timer.nosetup_us / 1e6:.2f}s, "
         f"{cps / 1e9:.3f} G cell-updates/s; population {population}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
