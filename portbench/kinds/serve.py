"""The ``serve`` traffic: a service with many live boards of one plan.
One ``SessionManager`` (the card, its micro-batcher, no observability,
no state dir) holds ``sessions`` boards made from the seed; as many
closed-loop client threads, one a session, each send ``requests`` step
requests of ``generations_per_request`` generations through
``SessionManager.step``, one after another, so that concurrent requests
coalesce into one batched launch a pass.

Traffic parameters: ``sessions``, ``rows``, ``cols``, ``density``,
``generations_per_request``, ``batch_max``, ``batch_window_ms`` (the
manager's), ``warmup_requests`` (a client's requests on a second set of
sessions before the window, untimed then timed, which size the window:
set-up) and ``sampled_sessions`` (sessions, drawn from the seed, whose
first request and one in the middle of the window are checked).

Each request is timed from the client's call to its reply.  The window
runs from the moment every client is released to the last reply.

The check: every session's last request, and the first request (from
the board the harness made) and one in the middle of the window of each
sampled session, are stepped again by the reference and compared cell by
cell with what the session held after them; every session's generation
must be its requests times their generations, and every request must be
answered.  For a
request past the first the reference follows the program from the
session's own board before it (copied on the card under the session's
lock, outside the request's time): a window's hundreds of thousands of
generations are too long to recompute.  The harness's boards and the
check's copies are made before the program's first allocation and are
not counted in its memory peak.
"""

from __future__ import annotations

import math
import random
import threading
import time

import numpy as np

from portbench import board, roofline
from portbench.kinds.common import Outcome, Phases, sync
from portbench.reference.cells import (
    count_wrong, port_rule_text, unpack, words,
)


def run(ctx) -> Outcome:
    import torch
    from mpi_tpu_torch.serve.session import SessionManager

    phases = Phases(ctx)
    tr, cfg = ctx.traffic, ctx.config
    S, rows, cols = tr["sessions"], tr["rows"], tr["cols"]
    G, K = tr["generations_per_request"], cfg["comm_every"]
    dev = torch.device(ctx.device)
    spec = {"rows": rows, "cols": cols, "rule": port_rule_text(ctx.rule),
            "boundary": cfg["boundary"], "comm_every": K, "segments": [G]}
    boards = board.soup(board.generator(ctx.seed, dev), S, rows, cols,
                        tr["density"], dev)
    cells = unpack(boards)[..., :cols].cpu().numpy()
    k = min(tr["sampled_sessions"], S)
    # the check's copies: every session's board before its last request,
    # before and after a middle one and after the first of the sampled
    pool = [torch.empty_like(boards[0]) for _ in range(S + 3 * k)]
    phases.mark("inputs")
    ctx.program_start()
    manager = SessionManager(batch_max=tr["batch_max"],
                             batch_window_ms=tr["batch_window_ms"],
                             device=ctx.device)
    warm = [manager.create(spec)["id"] for _ in range(S)]
    sids = [manager.create(spec)["id"] for _ in range(S)]
    for sid, b in zip(sids, cells):
        manager.write_board(sid, b)
    del cells
    engine = manager.get(sids[0]).engine
    for B in range(2, min(S, tr["batch_max"]) + 1):
        engine.ensure_compiled_batched(torch.empty(
            (B, rows, words(cols)), dtype=torch.int32, device=dev), G)
    phases.mark("engine")
    W = tr["warmup_requests"]
    _drive(manager, warm, G, W // 2)
    t0, _, done, errors = _drive(manager, warm, G, W - W // 2)
    if errors:
        raise RuntimeError(f"warm-up requests failed: {errors[:3]}")
    rate = S * (W - W // 2) / (max(done) - t0)
    for sid in warm:
        manager.close(sid)
    n = max(3, math.ceil(ctx.seconds * rate / S))
    rng = random.Random(ctx.seed)
    sampled = sorted(rng.sample(range(S), k))
    middle = {(i, rng.randrange(1, n - 1)) for i in sampled}
    before = dict.fromkeys({(i, n - 1) for i in range(S)} | middle)
    after = dict.fromkeys({(i, 0) for i in sampled} | middle)
    phases.mark("warmup")
    stats0 = manager.batcher.stats()
    cap = ctx.capture
    with cap:
        sync(dev)
        t0, lat, done, errors = _drive(manager, sids, G, n, before, after,
                                       cap, pool)
        sync(dev)
    stats1 = manager.batcher.stats()
    peak = ctx.memory_peak()
    trace = cap.reduce()
    finals, gens = [], []
    for sid in sids:
        session = manager.get(sid)
        with session.lock:
            finals.append(session.grid.clone())
            gens.append(session.generation)
    snaps = {key: (before.get(key), after.get(key))
             for key in set(before) | set(after)}
    manager.shutdown()
    del manager, engine
    ctx.free()
    completed = sum(len(x) for x in lat)
    t2 = time.perf_counter()
    wrong = _wrong(ctx, boards, snaps, finals, sampled, middle, n, G, cols)
    check_s = time.perf_counter() - t2
    rounds = (stats1["coalesced_calls"] - stats0["coalesced_calls"]
              + stats1["solo_steps"] - stats0["solo_steps"])
    boards_run = (stats1["batched_boards"] - stats0["batched_boards"]
                  + stats1["solo_steps"] - stats0["solo_steps"])
    window = max(done) - t0
    lat_ms = np.array([v for x in lat for v in x]) * 1e3
    return Outcome(
        e2e={"served_cell_updates_per_s":
             completed * rows * cols * G / window,
             "step_p95_ms": float(np.percentile(lat_ms, 95)),
             "setup_s": t0 - ctx.t0},
        attempted=S * n, failed=len(errors),
        checks=[("cells_wrong", wrong, 0),
                ("generations_off", sum(abs(g - n * G) for g in gens), 0),
                ("requests_failed", len(errors), 0)],
        memory_peak_bytes=peak, trace=trace,
        work={"word_gen_ops": roofline.word_gen_ops(cfg),
              "cells": rows * cols, "gens_per_pass": K,
              "board_bytes": rows * words(cols) * 4,
              "board_passes": completed * math.ceil(G / K),
              "rounds": rounds, "boards_dispatched": boards_run},
        window_s=window, check_s=check_s, setup_phases=phases.ends)


def _copy(session, into: dict, key, cap, pool: list) -> None:
    with cap.span("check.copy"), session.lock:
        buf = pool.pop()
        buf.copy_(session.grid)
        into[key] = buf


def _drive(manager, sids, G: int, n: int, before=None, after=None,
           cap=None, pool=None):
    """``len(sids)`` client threads, each sending ``n`` requests of ``G``
    generations to its own session, the next when the last has replied.
    The session's board is copied into ``before`` and ``after`` (dicts
    keyed by (client, request)) around the requests their keys name, into
    buffers taken from ``pool``.
    Returns (the time the clients were released, each client's request
    latencies in seconds, each client's last reply time, the errors)."""
    from portbench.devtrace import Capture

    cap = cap or Capture(False, False)
    before, after = before or {}, after or {}
    S = len(sids)
    started = []
    barrier = threading.Barrier(
        S + 1, action=lambda: started.append(time.perf_counter()))
    lat = [[] for _ in range(S)]
    done = [0.0] * S
    errors = []

    def client(i: int) -> None:
        sid = sids[i]
        session = manager.get(sid)
        barrier.wait()
        for k in range(n):
            if (i, k) in before:
                _copy(session, before, (i, k), cap, pool)
            t = time.perf_counter()
            try:
                with cap.span("client.step"):
                    manager.step(sid, G)
            except Exception as e:  # noqa: BLE001 — counted as failed
                errors.append(f"{sid} request {k}: {type(e).__name__}: {e}")
                continue
            t2 = time.perf_counter()
            lat[i].append(t2 - t)
            done[i] = t2
            if (i, k) in after:
                _copy(session, after, (i, k), cap, pool)

    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(S)]
    for t in threads:
        t.start()
    barrier.wait()
    with cap.span("window"):
        for t in threads:
            t.join()
    return started[0], lat, done, errors


def _wrong(ctx, boards, snaps, finals, sampled, middle, n: int, G: int,
           cols: int) -> int:
    """Cells wrong over every checked request (a request whose board was
    not copied, having failed, counts its whole board)."""
    import torch

    rule, boundary = ctx.rule, ctx.config["boundary"]
    whole = boards.shape[-2] * cols

    def check(pairs) -> int:
        pairs = list(pairs)
        ok = [(b, a) for b, a in pairs if b is not None and a is not None]
        missing = (len(pairs) - len(ok)) * whole
        if not ok:
            return missing
        return missing + count_wrong(
            torch.stack([b for b, _ in ok]), torch.stack([a for _, a in ok]),
            rule, G, cols, boundary)

    wrong = check((boards[i], snaps[(i, 0)][1]) for i in sampled)
    wrong += check(snaps[key] for key in sorted(middle))
    wrong += check((snaps[(i, n - 1)][0], finals[i])
                   for i in range(len(finals)))
    return wrong
