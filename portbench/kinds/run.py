"""The ``run`` traffic: one board, made from the seed on the device,
stepped by the engine in passes of ``comm_every`` generations for the
whole window with nothing fetched inside it, the loop the program's
one-shot run (``backends/cuda.py:run_cuda``) runs.

Traffic parameters: ``rows``, ``cols`` (any width; one that is not whole
words takes the padded engine), ``density`` of the soup,
``warmup_passes`` (full-size passes on a copy of the board, set-up),
``timing_passes`` (passes timed by CUDA events to size the window) and
``sampled_passes`` (passes of the window, drawn from the seed, whose
input and output are copied for the check).

The window runs as many passes as the pass time that set-up measured fits
into ``--seconds``, and ends in ``torch.cuda.synchronize()``.  The board
the harness made and the check's copies are made before the program's
first allocation and are not counted in its memory peak.

The check: the reference steps the input of the first pass (the board the
harness made), of each sampled pass and of the last pass by
``comm_every`` generations and compares every cell with the pass's output.
Past the first pass, the reference follows the program from the
program's own state, one pass at a time: a window of thousands of passes
is too long to recompute.
"""

from __future__ import annotations

import random
import time

from portbench import board, roofline
from portbench.harness import MidWindow
from portbench.kinds.common import Outcome, Phases, port_config, sync
from portbench.reference.cells import WORD, count_wrong, words


def run(ctx) -> Outcome:
    import torch
    from mpi_tpu_torch.backends.cuda import build_engine

    phases = Phases(ctx)
    tr, cfg = ctx.traffic, ctx.config
    rows, cols, K = tr["rows"], tr["cols"], cfg["comm_every"]
    dev = torch.device(ctx.device)
    nw = words(cols)
    initial = board.soup(board.generator(ctx.seed, dev), 1, rows, cols,
                         tr["density"], dev)[0]
    # the check's copies: the input of each sampled pass and of the last,
    # the output of the first and of each sampled pass
    spare = [torch.empty_like(initial)
             for _ in range(2 * (tr["sampled_passes"] + 1))]
    phases.mark("inputs")
    ctx.program_start()
    engine = build_engine(port_config(ctx, rows, cols), device=dev,
                          depths=[K])
    if engine.cols_eff != nw * WORD:
        raise RuntimeError(f"the engine holds {engine.cols_eff} columns a "
                           f"row, the harness's boards {nw * WORD}")
    engine.warm_up()
    phases.mark("engine")
    grid = initial.clone()
    for _ in range(tr["warmup_passes"]):
        grid = engine.step(grid, K)
    pass_s = _pass_seconds(engine, grid, K, tr["timing_passes"], dev)
    del grid
    n = max(4, round(ctx.seconds / pass_s))
    sampled = random.Random(ctx.seed).sample(
        range(1, n - 1), min(tr["sampled_passes"], n - 2))
    before = {i: spare.pop() for i in sampled + [n - 1]}
    after = {i: spare.pop() for i in sampled + [0]}
    grid = initial.clone()
    phases.mark("warmup")
    cap = ctx.capture
    probe = MidWindow(ctx, ctx.seconds / 2)
    with cap:
        sync(dev)
        t0 = time.perf_counter()
        probe.start()
        with cap.span("window"):
            for i in range(n):
                if i in before:
                    with cap.span("check.copy"):
                        before[i].copy_(grid)
                with cap.span("engine.step"):
                    grid = engine.step(grid, K)
                if i in after:
                    with cap.span("check.copy"):
                        after[i].copy_(grid)
            sync(dev)
        t1 = time.perf_counter()
    peak = ctx.memory_peak()
    under_load = probe.result()
    trace = cap.reduce()
    del engine
    ctx.free()
    t2 = time.perf_counter()
    wrong = count_wrong(initial, after[0], ctx.rule, K, cols,
                        cfg["boundary"])
    for i in sampled:
        wrong += count_wrong(before[i], after[i], ctx.rule, K, cols,
                             cfg["boundary"])
    wrong += count_wrong(before[n - 1], grid, ctx.rule, K, cols,
                         cfg["boundary"])
    return Outcome(
        e2e={"cell_updates_per_s": n * rows * cols * K / (t1 - t0),
             "setup_s": t0 - ctx.t0},
        attempted=n, failed=0,
        checks=[("cells_wrong", wrong, 0)],
        memory_peak_bytes=peak, trace=trace,
        work={"word_gen_ops": roofline.word_gen_ops(cfg),
              "cells": rows * cols, "gens_per_pass": K,
              "board_bytes": rows * nw * 4},
        window_s=t1 - t0, check_s=time.perf_counter() - t2,
        setup_phases=phases.ends, under_load=under_load)


def _pass_seconds(engine, grid, K: int, passes: int, dev) -> float:
    """Seconds a pass takes, by CUDA events over ``passes`` passes (the
    host clock on the CPU)."""
    import torch

    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(passes):
            grid = engine.step(grid, K)
        return (time.perf_counter() - t0) / passes
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(passes):
        grid = engine.step(grid, K)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / passes
