"""Async ticketed stepping — the pipelined dispatch loop.

The sync step path holds its caller's thread through the wait for the
device, so the MicroBatcher can only coalesce requests that happen to
collide inside a 2 ms window while their callers block.  This module
decouples the two halves: :meth:`SessionManager.step_async` enqueues a
:class:`Ticket` and returns immediately; a per-
:class:`~mpi_tpu_torch.serve.session.SessionManager` dispatch loop owns
device submission, so the asynchronous kernel launches overlap the
callers' work and checkpoint writes, and
:meth:`SessionManager.ticket_result` (or its blocking ``wait=True``
variant) delivers the eventual outcome — which may be an error, because
tickets carry the exact deadline/watchdog/breaker semantics of the
blocking verbs: a ticket's budget starts at enqueue, and an expired
queued ticket is drained with
:class:`~mpi_tpu_torch.serve.session.DeadlineError` without ever
dispatching.

**Heterogeneous-depth (unit-step) scheduling.**  The sync batcher keys
its queues on ``(plan_signature, depth)``, so a depth-3 and a depth-1
request never share a launch.  The dispatch loop instead decomposes a
depth-k ticket into k *unit steps* scheduled round-by-round: each round
takes the head ticket of every session, groups the engine-backed heads
by engine, and advances each group through a **cohort-chunked chain**
of depth-1 steps: boards sorted by remaining depth advance together —
stacked ``[B, ...]`` batched steps when B >= 2 (``Engine.step_batched``
at depth 1, one kernel launch a generation for the batch), an
``Engine.step_units`` chain when alone — up to the shallowest cohort's
depth, finished lanes peel off, and the narrower stack continues, with
ONE wait for the device at the end of the whole chain.  Mixed-depth
sessions therefore share launches for as long as their remaining depths
overlap, every head ticket finishes its full depth in one round (a
{1, 16} mix costs one wait, not sixteen), and only depth 1 (the one
depth every session warms) is ever needed.

In-order completion per session is structural: one dispatch loop, one
FIFO queue per session, only the head ticket ever runs.  Generations
stay monotonic and commits (generation bump + checkpoint) happen only
after the chain's wait (``Engine.block_until_ready``) returns, so a
``kill -9`` mid-flight restores to the last *completed* chain, never
past it.

Failure discipline mirrors the MicroBatcher: any group-chain failure
counts ONE engine failure against the signature's breaker, then every
ticket in the group falls back to the solo step path —
``SessionManager.step`` with the ticket's original enqueue deadline —
which owns retry/backoff, breaker re-check, degradation, and the
watchdog.  Batching never changes results; it only removes launches.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from mpi_tpu_torch.obs.trace import (
    current_request_id, reset_request_id, set_request_id,
)
from mpi_tpu_torch.obs.tracectx import (
    current_trace_context, reset_trace_context, set_trace_context,
)


class TicketQueueFullError(RuntimeError):
    """The async queue is at its bound (``async_queue_max``) —
    backpressure, not a bug.  Maps to HTTP 503: retry later."""


class Ticket:
    """One enqueued async step.  ``status`` moves pending -> done|error
    exactly once; ``event`` wakes ``?wait=1`` pollers.  ``deadline``
    (a ``session._Deadline``) started counting at enqueue.  ``rid``
    carries the enqueuing request's id across the thread hop to the
    dispatch loop, same as the MicroBatcher's ``_Entry.rid``; ``tctx``
    persists the minting trace context the same way, so the spans the
    dispatch loop records for this ticket stitch under the enqueuing
    request wherever it entered the cluster."""

    __slots__ = ("id", "sid", "steps", "remaining", "deadline", "status",
                 "result", "error", "event", "rid", "tctx",
                 "enqueued_mono", "done_mono", "unit_rounds",
                 "max_batched", "qos", "cost")

    def __init__(self, tid: str, sid: str, steps: int, deadline,
                 qos: str = "standard", cost: float = 0.0):
        self.id = tid
        self.sid = sid
        self.steps = int(steps)
        self.remaining = int(steps)
        self.deadline = deadline
        # admission-control tags: priority class and the CostCard
        # estimate (ops) used for head-of-line ordering.  Unarmed
        # servers leave the defaults and never read them.
        self.qos = qos
        self.cost = float(cost)
        self.status = "pending"
        self.result: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.event = threading.Event()
        self.rid = current_request_id()
        self.tctx = current_trace_context()
        self.enqueued_mono = time.monotonic()
        self.done_mono: Optional[float] = None
        self.unit_rounds = 0            # device rounds this ticket rode in
        self.max_batched = 0            # widest batch it shared (0 = solo)


class AsyncDispatcher:
    """The per-manager dispatch loop plus its ticket table.

    Thread model: ``submit``/``get``/gauge callbacks run on HTTP worker
    threads and touch shared state only under ``_cv``; the single
    dispatch-loop thread (started lazily on the first submit, daemon) is
    the only mutator of the per-session queues between rounds and the
    only caller of device work.  Lock order is session.lock -> _cv
    (commit counters update while session locks are held); nothing ever
    acquires a session lock while holding ``_cv``.

    Counters are the authoritative source for the ``/stats`` ``async``
    section and the scrape-time ticket gauges — no shadow counting.
    """

    def __init__(self, manager, window_s: float = 0.002,
                 queue_max: int = 1024, retain: int = 4096,
                 ticket_ttl_s: float = 600.0):
        self.manager = manager
        self.window_s = max(0.0, float(window_s))
        if queue_max < 1:
            raise ValueError(f"async queue_max must be >= 1, got {queue_max}")
        self.queue_max = int(queue_max)
        # resolved-ticket retention: a resolved ticket stays resolvable
        # for ticket_ttl_s seconds (0 disables the clock), with `retain`
        # as the hard size cap either way — bursty small-ticket traffic
        # is bounded by BOTH time and count, not count alone
        self.retain = max(1, int(retain))
        self.ticket_ttl_s = max(0.0, float(ticket_ttl_s))
        self._cv = threading.Condition()
        self._inbox: List[Ticket] = []              # enqueued, unadmitted
        self._per_session: Dict[str, List[Ticket]] = {}     # admitted FIFO
        self._tickets: Dict[str, Ticket] = {}
        self._done_order: deque = deque()           # resolved-ticket eviction
        self._completed_by_sid: Dict[str, int] = {}
        self._next = 0
        # appended to every allocated ticket id ("@<node-tag>" in the
        # reference's cluster mode, which ROADMAP item 11b brings; empty
        # until then)
        self.id_suffix = ""
        self._thread: Optional[threading.Thread] = None
        self._stopping = False
        self.tickets_enqueued = 0
        self.tickets_completed = 0
        self.tickets_expired = 0        # drained by deadline, pre- or mid-flight
        self.group_dispatches = 0       # watchdogged unit-round chains
        self.unit_rounds = 0            # depth-1 rounds executed (chain links)
        self.board_rounds = 0           # boards x rounds (occupancy numerator)
        self.max_occupancy = 0
        self.solo_tickets = 0           # tickets routed to the solo step path
        self.batched_fallbacks = 0      # group chains that fell back solo

    # -- client side (HTTP worker threads) ---------------------------------

    def submit(self, sid: str, steps: int, deadline,
               qos: str = "standard", cost: float = 0.0) -> Ticket:
        with self._cv:
            if self._stopping:
                raise RuntimeError("the async dispatcher is stopped")
            depth = (len(self._inbox)
                     + sum(len(q) for q in self._per_session.values()))
            if depth >= self.queue_max:
                raise TicketQueueFullError(
                    f"async queue full ({depth} tickets queued, bound "
                    f"{self.queue_max}); retry later or raise "
                    f"async_queue_max")
            self._next += 1
            ticket = Ticket(f"t{self._next}{self.id_suffix}", sid, steps,
                            deadline, qos=qos, cost=cost)
            self._tickets[ticket.id] = ticket
            self._inbox.append(ticket)
            self.tickets_enqueued += 1
            if self._thread is None:
                # lazily started: a sync-only server never runs the loop
                self._thread = threading.Thread(
                    target=self._loop, daemon=True,
                    name="mpi_tpu_torch-dispatch")
                self._thread.start()
            self._cv.notify()
        return ticket

    def get(self, tid: str) -> Ticket:
        with self._cv:
            ticket = self._tickets.get(tid)
        if ticket is None:
            raise KeyError(tid)
        return ticket

    def stop(self, timeout_s: float = 30.0) -> None:
        """End the dispatch loop once its current round is done and wait
        up to ``timeout_s`` for it; tickets still queued are left pending,
        and later submits raise."""
        with self._cv:
            self._stopping = True
            thread = self._thread
            self._cv.notify()
        if thread is not None:
            thread.join(timeout_s)

    # -- authoritative gauges (scraped + /stats + describe) ----------------

    def queue_depth(self) -> int:
        """Tickets waiting for the dispatch loop (not yet in a round)."""
        with self._cv:
            return (len(self._inbox)
                    + sum(len(q) for q in self._per_session.values()))

    def pending(self) -> int:
        """Tickets enqueued but not yet resolved (includes in-dispatch)."""
        with self._cv:
            return sum(1 for t in self._tickets.values()
                       if t.status == "pending")

    def queued_for(self, sid: str) -> int:
        with self._cv:
            return (sum(1 for t in self._inbox if t.sid == sid)
                    + len(self._per_session.get(sid, ())))

    def pending_for(self, sid: str) -> int:
        with self._cv:
            return sum(1 for t in self._tickets.values()
                       if t.sid == sid and t.status == "pending")

    def completed_for(self, sid: str) -> int:
        with self._cv:
            return self._completed_by_sid.get(sid, 0)

    def stats(self) -> dict:
        with self._cv:
            self._evict_locked()        # TTL fires on scrape too, so an
            rounds = self.unit_rounds   # idle server still sheds tickets
            return {
                "queue_depth": (len(self._inbox)
                                + sum(len(q)
                                      for q in self._per_session.values())),
                "tickets_pending": sum(1 for t in self._tickets.values()
                                       if t.status == "pending"),
                "tickets_enqueued": self.tickets_enqueued,
                "tickets_completed": self.tickets_completed,
                "tickets_expired": self.tickets_expired,
                "group_dispatches": self.group_dispatches,
                "unit_rounds": rounds,
                "board_rounds": self.board_rounds,
                "avg_occupancy": (round(self.board_rounds / rounds, 3)
                                  if rounds else None),
                "max_occupancy": self.max_occupancy,
                "solo_tickets": self.solo_tickets,
                "batched_fallbacks": self.batched_fallbacks,
                "window_ms": self.window_s * 1e3,
                "queue_max": self.queue_max,
                "ticket_ttl_s": self.ticket_ttl_s,
                "tickets_retained": len(self._done_order),
            }

    # -- completion --------------------------------------------------------

    def _complete(self, ticket: Ticket, result=None, error=None) -> None:
        with self._cv:
            if ticket.status != "pending":
                return
            ticket.status = "done" if error is None else "error"
            ticket.result = result
            ticket.error = error
            ticket.done_mono = time.monotonic()
            self.tickets_completed += 1
            self._completed_by_sid[ticket.sid] = (
                self._completed_by_sid.get(ticket.sid, 0) + 1)
            self._done_order.append((ticket.id, ticket.done_mono))
            self._evict_locked()
        ticket.event.set()

    def _evict_locked(self) -> None:  # lint: disable=lock-discipline -- caller holds _cv (_locked suffix contract)
        """Age out the oldest RESOLVED tickets: anything beyond the
        ``retain`` size cap, plus anything older than ``ticket_ttl_s``
        (0 = no clock).  A pending ticket is never evicted — its id must
        resolve.  Caller holds ``_cv``."""
        cutoff = (time.monotonic() - self.ticket_ttl_s
                  if self.ticket_ttl_s else None)
        while self._done_order and (
                len(self._done_order) > self.retain
                or (cutoff is not None and self._done_order[0][1] <= cutoff)):
            tid, _ = self._done_order.popleft()
            self._tickets.pop(tid, None)

    # -- the dispatch loop -------------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cv:
                while (not self._inbox and not self._per_session
                       and not self._stopping):
                    self._cv.wait()
                if self._stopping:
                    return
                fresh_burst = not self._per_session
            if fresh_burst and self.window_s:
                # admission window: let a burst of enqueues land before
                # the first round, so its tickets share the first batch
                time.sleep(self.window_s)
            with self._cv:
                inbox, self._inbox = self._inbox, []
                for t in inbox:
                    self._per_session.setdefault(t.sid, []).append(t)
            try:
                self._run_round()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # a scheduler bug must not strand every pending ticket;
                # the round's heads get the error, the loop continues
                print(f"note: async dispatch round failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                traceback.print_exc(file=sys.stderr)
                with self._cv:
                    heads = [q[0] for q in self._per_session.values() if q]
                for t in heads:
                    self._complete(t, error=RuntimeError(
                        f"async dispatch round failed: "
                        f"{type(e).__name__}: {e}"))

    def _run_round(self) -> None:
        from mpi_tpu_torch.serve.session import DeadlineError

        manager = self.manager
        admission = getattr(manager, "admission", None)
        with self._cv:
            for sid in list(self._per_session):
                q = self._per_session[sid]
                while q and q[0].status != "pending":
                    q.pop(0)
                if not q:
                    del self._per_session[sid]
            all_heads = [q[0] for q in self._per_session.values()]
            if admission is None or not all_heads:
                heads = sorted(all_heads, key=lambda t: t.sid)
            else:
                # cost-aware class scheduling: the weighted picker names
                # the class served this round (interactive > standard >
                # bulk, smooth 4:2:1 — no class with queued work
                # starves), and within the class the cheapest estimated
                # work (CostCard ops) runs first so a bulk mega-board
                # never rides ahead of viewport traffic
                cls = admission.picker.pick(
                    list({t.qos for t in all_heads}))
                heads = sorted((t for t in all_heads if t.qos == cls),
                               key=lambda t: (t.cost, t.sid))
        # deadline drain first: the budget started at enqueue, and an
        # expired ticket must never dispatch (a queued one) nor advance
        # further (a partially-advanced one)
        runnable = []
        for t in heads:
            if t.deadline.expired():
                with self._cv:
                    self.tickets_expired += 1
                done = t.steps - t.remaining
                self._complete(t, error=DeadlineError(
                    f"ticket {t.id} exceeded its "
                    f"{t.deadline.seconds:.3g}s budget while queued "
                    f"({done} of {t.steps} steps dispatched; the session "
                    f"survives)"))
                if manager.obs is not None:
                    # drained on the loop thread: re-enter the minting
                    # context so the expiry is greppable by trace id
                    ttoken = (set_trace_context(t.tctx)
                              if t.tctx is not None else None)
                    try:
                        manager.obs.event("ticket_expired", sid=t.sid,
                                          ticket=t.id, dispatched=done,
                                          rid=t.rid)
                    finally:
                        if ttoken is not None:
                            reset_trace_context(ttoken)
            else:
                runnable.append(t)
        groups: Dict[int, list] = {}
        solos: List[Ticket] = []
        for t in runnable:
            try:
                session = manager.get(t.sid)
            except KeyError as e:
                self._complete(t, error=e)
                continue
            if (session.engine is None or session.plan_sig is None
                    or not manager.cache.breaker_allows(session.plan_sig)):
                # host backends, degraded boards, and quarantined plans
                # take the solo path — manager.step owns breaker
                # handling (degrade or 503) exactly as the sync path does
                solos.append(t)
            else:
                groups.setdefault(id(session.engine),
                                  []).append((t, session))
        for group in groups.values():
            solos.extend(self._run_group(group))
        for t in solos:
            self._run_solo(t)

    def _run_group(self, group) -> List[Ticket]:
        """One cohort-chunked chain for the head tickets sharing an
        engine: boards sorted by remaining depth advance together in
        stacked depth-1 dispatches up to the shallowest cohort's depth,
        finished lanes peel off, and the narrower stack continues —
        every head ticket completes in ONE chain with ONE sync at the
        end.  (The previous ``r = min(remaining)`` round rule made a
        {1, 16} depth mix re-sync for every depth-1 arrival — 16 syncs
        for the deep ticket; cohort lookahead keeps it at one per
        round.)  Returns the tickets that must fall back to the solo
        path (run by the caller AFTER the session locks here are
        released — the solo path takes them itself)."""
        from mpi_tpu_torch.serve.session import (
            _Deadline, _watchdog_call, DeadlineError,
        )

        manager = self.manager
        obs = manager.obs
        group.sort(key=lambda ts: ts[1].id)
        engine = group[0][1].engine
        # the watchdog budget for the shared chain is the tightest
        # participant's remaining budget — a timeout fails the chain and
        # every ticket re-tries solo under its OWN deadline
        finite = [t.deadline.remaining() for t, _ in group
                  if t.deadline.seconds is not None]
        deadline = _Deadline(min(finite) if finite else None)
        for _, s in group:
            s.lock.acquire()
        try:
            for t, s in group:
                if s.closed or s.engine is None:
                    self._complete(t, error=KeyError(s.id))
            live = [(t, s) for t, s in group
                    if not (s.closed or s.engine is None)]
            if not live:
                return []
            # ascending remaining depth = the cohort peel order
            live.sort(key=lambda ts: (ts[0].remaining, ts[1].id))
            B = len(live)
            rem = [t.remaining for t, _ in live]
            chain = rem[-1]             # deepest cohort = chain length
            sig = live[0][1].plan_sig
            t1 = time.perf_counter()

            def work():  # lint: disable=lock-discipline -- _run_group holds every participant's session.lock around the chain
                if B == 1:
                    s = live[0][1]
                    s.engine.ensure_compiled(s.grid, 1)
                    g = engine.step_units(s.grid, rem[0])
                    return [engine.block_until_ready(g)]
                finals = [None] * B
                grids = [s.grid for _, s in live]
                lanes = list(range(B))  # still running, ascending rem
                done = 0                # generations advanced so far
                while lanes:
                    target = rem[lanes[0]]
                    if len(lanes) == 1:
                        i = lanes[0]
                        engine.ensure_compiled(grids[i], 1)
                        grids[i] = engine.step_units(grids[i],
                                                     target - done)
                    else:
                        Bc = len(lanes)
                        stepper, _hit = manager.cache.get_or_build_batched(
                            sig, Bc,
                            lambda Bc=Bc: engine.batched_stepper(Bc))
                        stacked = engine.stack_grids(
                            [grids[i] for i in lanes])
                        engine.ensure_compiled_batched(stacked, 1)
                        for _ in range(target - done):
                            stacked = stepper(stacked, 1)
                        for i, g in zip(lanes,
                                        engine.unstack_grids(stacked)):
                            grids[i] = g
                    done = target
                    nxt = []
                    for i in lanes:
                        if rem[i] == done:
                            finals[i] = grids[i]
                        else:
                            nxt.append(i)
                    lanes = nxt
                engine.block_until_ready(finals[-1])
                return finals

            try:
                boards = _watchdog_call(work, deadline,
                                        f"unit_round[B={B},chain={chain}]",
                                        manager._workers)
            except Exception as e:  # noqa: BLE001 — solo fallback decides
                manager._engine_failure(live[0][1], sig, e,
                                        timeout=isinstance(e, DeadlineError))
                with self._cv:
                    self.batched_fallbacks += 1
                return [t for t, _ in live]
            # t2 - t1: the whole chain, its launches and the one wait for
            # them (Engine.block_until_ready in work), so on the card the
            # time is the chain's, not its enqueue
            t2 = time.perf_counter()
            if obs is not None:
                # every rider's trace context rides as a *link* — the
                # shared round is related to each minting request, not
                # parented under any one of them
                links = [t.tctx.link() for t, _ in live
                         if t.tctx is not None]
                obs.event("unit_round", t2 - t1, t1, B=B, rounds=chain,
                          cohorts=len(set(rem)),
                          sids=[s.id for _, s in live],
                          request_ids=[t.rid for t, _ in live],
                          **({"links": links} if links else {}))
                obs.occupancy_series.observe(B)
                (obs.dispatch_batched if B > 1
                 else obs.dispatch_solo).observe(t2 - t1)
                # usage ledger: the whole chain is ONE wait, however many
                # depth-1 rounds it stacked; instructions from the
                # chain's opening (depth-1, B) card, per
                # board-generation — the cohort peel shrinks B mid-chain,
                # which this ignores
                card = engine.cost_card(1, B if B > 1 else 0)
                pbg = (card.flops / card.boards
                       if card is not None else 0.0)
                obs.ledger.record(
                    "unit", engine.sig_label, t2 - t1,
                    [(s.id, t.remaining,
                      t.remaining * s.config.cells,
                      pbg * t.remaining) for t, s in live])
                fl = obs.flight
                if fl is not None:
                    fl.record("unit_round", engine=engine, steps=chain,
                              batch=B, device_s=t2 - t1,
                              sessions=[s.id for _, s in live],
                              request_ids=[t.rid for t, _ in live],
                              links=links or None)
            per_board = (t2 - t1) / B
            for (t, s), grid in zip(live, boards):
                adv = t.remaining       # cohort chains run to completion
                s.grid = grid
                s.generation += adv
                s.steady_s += per_board
                if B > 1:
                    s.batched_steps += 1
                # commit under the submitter's request id AND trace
                # context so the checkpoint write's span carries both
                # (loop thread)
                token = set_request_id(t.rid)
                ttoken = (set_trace_context(t.tctx)
                          if t.tctx is not None else None)
                try:
                    manager._checkpoint(s)
                finally:
                    if ttoken is not None:
                        reset_trace_context(ttoken)
                    reset_request_id(token)
                t.remaining = 0
                t.unit_rounds += adv
                t.max_batched = max(t.max_batched, B if B > 1 else 0)
                self._complete(t, result={
                    "id": s.id, "generation": s.generation,
                    "steps": t.steps, "async": True,
                    "unit_rounds": t.unit_rounds,
                    "max_batched": t.max_batched})
            manager._mark_dispatch_ok()
            manager._engine_success(sig)
            with self._cv:
                self.group_dispatches += 1
                self.unit_rounds += chain
                self.board_rounds += sum(rem)
                self.max_occupancy = max(self.max_occupancy, B)
            return []
        finally:
            for _, s in group:
                s.lock.release()

    def _run_solo(self, ticket: Ticket) -> None:
        """The solo path: ``manager.step`` with the ticket's original
        enqueue deadline, bypassing the sync MicroBatcher (one loop
        thread can never coalesce with itself) but keeping every fault
        semantic — breaker check, degrade, retry/backoff, watchdog —
        and chaining the remaining depth as unit steps."""
        manager = self.manager
        with self._cv:
            self.solo_tickets += 1
        token = set_request_id(ticket.rid)
        ttoken = (set_trace_context(ticket.tctx)
                  if ticket.tctx is not None else None)
        try:
            res = dict(manager.step(ticket.sid, ticket.remaining,
                                    _deadline=ticket.deadline,
                                    _use_batcher=False, _unit=True))
            res["steps"] = ticket.steps
            res["async"] = True
            res["unit_rounds"] = ticket.unit_rounds + ticket.remaining
            res["max_batched"] = ticket.max_batched
            ticket.unit_rounds += ticket.remaining
            ticket.remaining = 0
            self._complete(ticket, result=res)
        except Exception as e:  # noqa: BLE001 — delivered via the ticket
            if isinstance(e, _deadline_error_type()):
                with self._cv:
                    self.tickets_expired += 1
            self._complete(ticket, error=e)
        finally:
            if ttoken is not None:
                reset_trace_context(ttoken)
            reset_request_id(token)


def _deadline_error_type():
    from mpi_tpu_torch.serve.session import DeadlineError

    return DeadlineError
