"""Same-signature microbatch scheduler — the serving hot path batched.

Boards served together are often small, and a small board's step is
bound by what each step costs besides its kernels: the host's work to
launch them and the wait for the device.  N concurrent sessions stepping
once pay N of those.  The fix is the continuous-batching insight of LLM
serving (Orca, Yu et al., OSDI'22) applied to boards: requests whose
engine is IDENTICAL (same ``plan_signature``) and whose step depth
matches are coalesced into one stacked ``[B, ...]`` batch and advanced by
one ``Engine.step_batched`` call — one kernel launch a pass for all B
boards (the kernels' board axis).

Mechanics: ``submit`` enqueues the request into a per-``(signature,
depth)`` queue.  The FIRST arrival becomes the *leader*: it sleeps a
small coalescing window (``window_ms``), then drains the queue in chunks
of ``max_batch`` and executes each chunk; later arrivals are *followers*
that just wait for the leader to deliver their result.  Mismatched
pending depths land in different queues (and batches of one take the
plain solo path), a session already in the chunk steps solo after the
batch, and any batched-path failure falls back to stepping each board
solo — correctness NEVER depends on batching, it only removes launches.
Per-session locks are taken by the leader (in session-id order) for the
duration of the coalesced step, so snapshots and closes serialize
against the batch exactly as they do against a solo step.
"""

from __future__ import annotations

import threading
import time

from mpi_tpu_torch.obs.trace import (
    current_request_id, reset_request_id, set_request_id,
)
from mpi_tpu_torch.obs.tracectx import (
    current_trace_context, reset_trace_context, set_trace_context,
)


class _Entry:
    """One enqueued step request: filled with either ``result`` or
    ``error`` by the leader, then ``event`` wakes the waiting thread.
    ``rid`` carries the submitter's request id across the thread hop —
    the leader runs follower work on ITS thread, so the contextvar set
    by the HTTP handler does not flow; the leader re-enters each entry's
    id around its commit so downstream spans (checkpoint writes) land
    under the request that asked for them.  ``tctx`` carries the
    submitter's trace context across the same hop for the same reason."""

    __slots__ = ("session", "steps", "event", "result", "error", "rid",
                 "tctx")

    def __init__(self, session, steps: int):
        self.session = session
        self.steps = steps
        self.event = threading.Event()
        self.result = None
        self.error = None
        self.rid = current_request_id()
        self.tctx = current_trace_context()


class MicroBatcher:
    """Coalesces concurrent same-signature steps into batched dispatches.

    Counters (surfaced on ``/stats`` as the ``batch`` section):

    * ``coalesced_calls``/``batched_boards`` — batched device calls
      (B >= 2) and the boards they carried; occupancy = boards/calls.
    * ``solo_steps``/``solo_step_s`` — entries that went through the
      scheduler but stepped alone (single arrival in the window, engine
      mismatch, duplicate session in a chunk, batched-path failure).
    * ``batched_step_s`` — wall time inside the batched dispatches;
      ``batched_step_s / batched_boards`` is the measured per-board
      amortized dispatch+step cost, the number this scheduler exists to
      shrink.
    """

    def __init__(self, window_ms: float = 2.0, max_batch: int = 8):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.window_s = max(0.0, float(window_ms)) / 1e3
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._queues = {}                # (signature, steps, qos) -> [_Entry]
        self.coalesced_calls = 0
        self.batched_boards = 0
        self.max_occupancy = 0
        self.solo_steps = 0
        self.batched_step_s = 0.0
        self.solo_step_s = 0.0
        self.batched_fallbacks = 0       # batched attempts that fell solo

    # -- public ------------------------------------------------------------

    def submit(self, manager, session, steps: int) -> dict:
        """Step ``session`` by ``steps`` through the coalescing queue;
        blocks until the (own or some leader's) dispatch delivers.  Raises
        whatever the solo path would have raised (closed session ->
        KeyError, etc.)."""
        # admission tags the session with a priority class; batches
        # compose within class only (qos is None everywhere unarmed, so
        # the grouping — and the key — is unchanged on default servers)
        key = (session.plan_sig, steps, getattr(session, "qos", None))
        entry = _Entry(session, steps)
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                self._queues[key] = [entry]
                leader = True
            else:
                q.append(entry)
                leader = False
        if leader:
            if self.window_s:
                t0 = time.perf_counter()
                time.sleep(self.window_s)
                if manager.obs is not None:
                    manager.obs.event("batch_window",
                                      time.perf_counter() - t0, t0,
                                      sid=session.id)
            self._run_leader(manager, key)
        else:
            entry.event.wait()
        if entry.error is not None:
            raise entry.error
        return entry.result

    def queue_depth(self) -> int:
        """Entries currently waiting in coalescing queues (scraped as the
        ``mpi_tpu_batch_queue_depth`` gauge)."""
        with self._lock:
            return sum(len(q) for q in self._queues.values())

    def stats(self) -> dict:
        with self._lock:
            calls, boards = self.coalesced_calls, self.batched_boards
            return {
                "window_ms": self.window_s * 1e3,
                "max_batch": self.max_batch,
                "coalesced_calls": calls,
                "batched_boards": boards,
                "avg_occupancy": round(boards / calls, 3) if calls else None,
                "max_occupancy": self.max_occupancy,
                "solo_steps": self.solo_steps,
                "batched_fallbacks": self.batched_fallbacks,
                "batched_step_s": round(self.batched_step_s, 6),
                "solo_step_s": round(self.solo_step_s, 6),
                "amortized_board_step_s": (
                    round(self.batched_step_s / boards, 6) if boards else None
                ),
            }

    # -- leader ------------------------------------------------------------

    def reset_stats(self) -> None:
        """Zero the counters (the batched micro-benchmark warms compiles
        first, then measures a clean window)."""
        with self._lock:
            self.coalesced_calls = 0
            self.batched_boards = 0
            self.max_occupancy = 0
            self.solo_steps = 0
            self.batched_fallbacks = 0
            self.batched_step_s = 0.0
            self.solo_step_s = 0.0

    # -- leader ------------------------------------------------------------

    def _run_leader(self, manager, key) -> None:
        """Drain the queue in chunks until it is empty AND removed (the
        removal is atomic with seeing it empty, so a late arrival either
        lands in a chunk here or becomes the next leader)."""
        while True:
            with self._lock:
                q = self._queues.get(key, [])
                chunk = q[: self.max_batch]
                del q[: len(chunk)]
                if not q:
                    self._queues.pop(key, None)
                    done = True
                else:
                    done = False
            if chunk:
                self._run_chunk(manager, chunk)
            if done:
                return

    def _run_chunk(self, manager, entries) -> None:
        """Execute one drained chunk: lock every session (id order — the
        only multi-lock acquirer in the process, so order alone prevents
        deadlock), batch the groups that share an engine, solo the rest.
        EVERY entry leaves completed (result or error) and signaled."""
        steps = entries[0].steps
        try:
            # a session enqueued twice in one window must not appear twice
            # in one stacked batch (both lanes would step the same
            # pre-grid); the duplicate steps solo after the batch, under
            # the lock the first occurrence already holds
            seen, ordered, dupes = set(), [], []
            for e in entries:
                if id(e.session) in seen:
                    dupes.append(e)
                else:
                    seen.add(id(e.session))
                    ordered.append(e)
            ordered.sort(key=lambda e: e.session.id)
            for e in ordered:
                e.session.lock.acquire()
            try:
                live, groups = [], {}
                for e in ordered:
                    if e.session.closed or e.session.engine is None:
                        e.error = KeyError(e.session.id)
                    else:
                        live.append(e)
                        groups.setdefault(id(e.session.engine), []).append(e)
                for group in groups.values():
                    if len(group) >= 2:
                        self._step_group_batched(manager, group, steps)
                    else:
                        self._step_solo(manager, group[0], steps)
                for e in dupes:
                    if e.session.closed or e.session.engine is None:
                        e.error = KeyError(e.session.id)
                    else:
                        self._step_solo(manager, e, steps)
            finally:
                for e in ordered:
                    e.session.lock.release()
        finally:
            for e in entries:
                if e.result is None and e.error is None:
                    e.error = RuntimeError(
                        "microbatch leader failed before completing entry")
                e.event.set()

    def _step_solo(self, manager, entry, steps: int) -> None:
        # re-enter the submitter's request id (and trace context): this
        # runs on the LEADER's thread, whose contextvars belong to a
        # different request
        token = set_request_id(entry.rid)
        ttoken = (set_trace_context(entry.tctx)
                  if entry.tctx is not None else None)
        t0 = time.perf_counter()
        try:
            entry.result = manager._step_locked(entry.session, steps)
        except Exception as e:  # noqa: BLE001 — delivered to the waiter
            entry.error = e
        finally:
            if ttoken is not None:
                reset_trace_context(ttoken)
            reset_request_id(token)
        with self._lock:
            self.solo_steps += 1
            self.solo_step_s += time.perf_counter() - t0

    def _step_group_batched(self, manager, group, steps: int) -> None:  # lint: disable=lock-discipline -- leader path: _run_chunk holds every rider's session.lock (id-ordered)
        """One stacked step for a group of sessions sharing an engine; any
        failure falls back to stepping each board solo (the stack COPIES,
        so the per-session grids are untouched until the batch succeeds
        and the scatter replaces them)."""
        engine = group[0].session.engine
        B = len(group)
        try:
            # stacking + a first-(depth, B) warm-up are setup, not
            # stepping — same accounting split as the solo path
            t0 = time.perf_counter()
            stepper, _hit = manager.cache.get_or_build_batched(
                group[0].session.plan_sig, B,
                lambda: engine.batched_stepper(B))
            stacked = engine.stack_grids([e.session.grid for e in group])
            engine.ensure_compiled_batched(stacked, steps)
            t1 = time.perf_counter()
            out = engine.block_until_ready(stepper(stacked, steps))
            t2 = time.perf_counter()
            boards = engine.unstack_grids(out)
        except Exception:  # noqa: BLE001 — batching must never cost correctness
            with self._lock:
                self.batched_fallbacks += 1
            for e in group:
                self._step_solo(manager, e, steps)
            return
        obs = manager.obs
        if obs is not None:
            # t2 - t1: the batch's launches and the wait for them
            # (Engine.block_until_ready), so the time is the step's, not
            # its enqueue.  One step serves B requests: the span lists
            # every rid so any of them reconstructs this shared leg; each
            # rider's trace context rides as a *link*, never a parent —
            # the shared step belongs to no single trace
            links = [e.tctx.link() for e in group if e.tctx is not None]
            obs.event("batched_dispatch", t2 - t1, t1, B=B, steps=steps,
                      sids=[e.session.id for e in group],
                      request_ids=[e.rid for e in group],
                      **({"links": links} if links else {}))
            obs.occupancy_series.observe(B)
            if getattr(engine, "tuned_plan", None):
                obs.dispatch_batched_tuned.observe(t2 - t1)
            else:
                obs.dispatch_batched.observe(t2 - t1)
            tel = obs.telemetry
            if tel is not None:
                tel.dispatch_digest.observe(t2 - t1)
            # usage ledger: ONE wait split evenly across the B riders
            # (shares sum to the leader's block time); the failed-batch
            # path above commits nothing here — each solo fallback
            # records its own wait in _step_locked, never both
            card = engine.cost_card(steps, B)
            per_flops = card.flops / B if card is not None else 0.0
            obs.ledger.record(
                "batched", engine.sig_label, t2 - t1,
                [(e.session.id, steps, steps * e.session.config.cells,
                  per_flops) for e in group])
            fl = obs.flight
            if fl is not None:
                fl.record("batched", engine=engine, steps=steps,
                          batch=B, setup_s=t1 - t0, device_s=t2 - t1,
                          sessions=[e.session.id for e in group],
                          request_ids=[e.rid for e in group],
                          links=links or None)
        for e, grid in zip(group, boards):
            s = e.session
            s.setup_s += t1 - t0
            s.steady_s += t2 - t1
            s.grid = grid
            s.generation += steps
            s.batched_steps += 1
            # commit under the submitter's request id and trace context
            # (this is the leader's thread)
            token = set_request_id(e.rid)
            ttoken = (set_trace_context(e.tctx)
                      if e.tctx is not None else None)
            try:
                manager._checkpoint(s)  # session lock is held (leader)
            finally:
                if ttoken is not None:
                    reset_trace_context(ttoken)
                reset_request_id(token)
            manager._notify_step(s)
            e.result = {"id": s.id, "generation": s.generation,
                        "steps": steps, "batched": B}
        manager._mark_dispatch_ok()
        with self._lock:
            self.coalesced_calls += 1
            self.batched_boards += B
            self.max_occupancy = max(self.max_occupancy, B)
            self.batched_step_s += t2 - t1
