"""Board sessions: device-resident state between requests.

A session is one live board — created once (paying setup: planning, and
on a cache miss the warm-up of its pass depths, with a new rule's nvcc
build; nearly nothing on a hit), then stepped/inspected by any number of
requests.  ``cuda`` sessions step through kernels K1, K2 and K3 on one
device, ``serial`` sessions on the numpy oracle and ``cpp``/``cpp-par``
sessions on the native C++ engine (``backends/cpp.py``), so a served board
is bit-identical to the same config run one-shot (the parity tests in
``tests/test_torch_serve*.py`` hold the serve path to the reference's
``serial_np`` oracle).  A host backend serves only a session whose spec
names it: a ``cuda`` session never steps on the native engine.

Sessions and engines are decoupled: cuda sessions hold a *reference* to a
cached :class:`~mpi_tpu_torch.backends.cuda.Engine` plus their own grid
buffer, so N boards of the same shape share one engine.  Eviction from
the :class:`~mpi_tpu_torch.serve.cache.EngineCache` only drops the cache's
reference — live sessions keep theirs.

Stepping routes through the :class:`~mpi_tpu_torch.serve.batch.MicroBatcher`
(when enabled, the default): concurrent same-signature same-depth steps
coalesce into one stacked ``Engine.step_batched`` call — one kernel launch
a pass for the whole batch — while lone requests, host backends, and any
batched-path failure take the solo path, so batching only ever removes
launches, never changes results.

Fault tolerance wraps the whole step path:

* **Deadlines** — every verb accepts a time budget
  (``request_timeout_s`` default, per-request override); engine steps run
  inside a *watchdog* worker thread, so a hung wait for the device
  (``Engine.block_until_ready``) becomes a :class:`DeadlineError` while
  the caller walks free.  The wedged worker holds the session lock until
  the device call ends; every later request against that board times out
  cleanly instead of piling up.
* **Retry + circuit breaker** — transient engine failures retry with
  bounded exponential backoff inside the request's budget; consecutive
  failures are counted per plan signature in the
  :class:`~mpi_tpu_torch.serve.cache.EngineCache` breaker, and once it
  opens the affected sessions *degrade*: their board is rebuilt by
  deterministic replay (seed or last checkpoint → ``serial_np`` oracle,
  bit-identical) and served by the host stepper.  Results stay exact;
  only throughput degrades.  With degradation disabled an open breaker
  answers :class:`EngineUnavailableError`, and so does one on the card
  that a real failure (not an injected fault) opened: a session on the
  card never moves its work to the CPU.
* **Checkpoint/restore** — with a ``state_dir``, every committed step
  persists the session record (crash-safe, ``serve/recovery.py``) and a
  packed grid snapshot every ``checkpoint_every`` generations; a new
  manager over the same dir rebuilds every session by replay,
  bit-identical to an uninterrupted run.  A step commits only after its
  launches have run (``Engine.block_until_ready``).

Async ticketed stepping (``serve/ticket.py``) is opt-in per request:
:meth:`SessionManager.step_async` enqueues a ticket whose budget starts
at enqueue and whose eventual outcome — :meth:`SessionManager.ticket_result`
— carries the same deadline/breaker/watchdog semantics as the blocking
verbs.  The dispatch loop decomposes depth-k tickets into unit steps so
mixed-depth sessions share batched launches.

Observability is one optional handle, ``SessionManager(obs=Obs(...))``
(``mpi_tpu_torch/obs``): spans, metrics, the usage ledger, cost cards from
the kernels' own instruction counts, and when armed the flight recorder,
anomaly detector, SLO engine, time series and device-memory sampler.
Every instrumentation site guards on the handle and only reads what
happened: ``obs=None`` runs the uninstrumented path, and obs never changes
which device or engine steps a board.  Autotuned plans are ROADMAP item 12
(the manager refuses ``tune_cache``); the cluster and admission seams stay
as the reference has them, no-ops while unset.
"""

from __future__ import annotations

import contextlib
import contextvars
import sys
import threading
import time
from typing import Dict, Optional

import numpy as np

from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.config import ConfigError, GolConfig, plan_signature
from mpi_tpu_torch.models.rules import rule_from_name
from mpi_tpu_torch.serve import recovery
from mpi_tpu_torch.serve.batch import MicroBatcher
from mpi_tpu_torch.serve.cache import EngineCache, signature_label
from mpi_tpu_torch.serve.faults import InjectedFault
from mpi_tpu_torch.serve.ticket import AsyncDispatcher
from mpi_tpu_torch.utils.hashinit import init_tile_np

_SPEC_KEYS = {
    "rows", "cols", "rule", "boundary", "backend", "seed", "comm_every",
    "overlap", "mesh", "segments", "sparse_tile",
}


# the one device a session's plan spans (the port runs one device)
MESH_SHAPE = (1, 1)


def _span(obs, name, **fields):
    """A trace span when observability is on, a no-op context otherwise —
    the guard every instrumentation site in this module goes through, so
    ``obs=None`` runs the uninstrumented code path exactly."""
    if obs is None:
        return contextlib.nullcontext()
    return obs.span(name, **fields)


class DeadlineError(RuntimeError):
    """The request's time budget ran out (a slow or hung dispatch, or a
    board wedged behind one).  Maps to HTTP 503; the session survives."""


class EngineUnavailableError(RuntimeError):
    """The plan signature's circuit breaker is open and degradation is
    disabled — there is nothing left to serve the request with (503)."""


class EngineStepError(RuntimeError):
    """An engine step failed and retries were exhausted without tripping
    the breaker (503; the client may retry — the breaker is counting)."""


def _parse_spec(spec: dict):
    """(GolConfig, segments) from a create-request JSON body.  Strict on
    key names — a typoed knob silently falling back to its default is the
    worst failure mode a service API can have."""
    if not isinstance(spec, dict):
        raise ConfigError(f"session spec must be a JSON object, got {type(spec).__name__}")
    unknown = set(spec) - _SPEC_KEYS
    if unknown:
        raise ConfigError(
            f"unknown session keys {sorted(unknown)}; allowed: {sorted(_SPEC_KEYS)}"
        )
    try:
        rows = int(spec["rows"])
        cols = int(spec["cols"])
    except KeyError as e:
        raise ConfigError(f"session spec needs {e.args[0]!r}")
    backend = str(spec.get("backend", "cuda"))
    mesh = spec.get("mesh")
    if isinstance(mesh, str):
        try:
            a, b = mesh.lower().split("x")
            mesh = (int(a), int(b))
        except ValueError:
            raise ConfigError(f"mesh must look like 2x4, got {mesh!r}")
    elif mesh is not None:
        try:
            a, b = mesh
            mesh = (int(a), int(b))
        except (TypeError, ValueError):
            raise ConfigError(f"mesh must be 'IxJ' or [i, j], got {mesh!r}")
    segments = spec.get("segments", [1])
    try:
        segments = sorted({int(n) for n in segments if int(n) > 0})
    except (TypeError, ValueError):
        raise ConfigError(f"segments must be a list of ints, got {spec.get('segments')!r}")
    config = GolConfig(
        rows=rows,
        cols=cols,
        steps=0,                       # sessions step on demand, not by plan
        seed=int(spec.get("seed", 0)),
        rule=rule_from_name(str(spec.get("rule", "life"))),
        boundary=str(spec.get("boundary", "periodic")),
        backend=backend,
        mesh_shape=mesh,
        comm_every=int(spec.get("comm_every", 1)),
        overlap=bool(spec.get("overlap", False)),
        sparse_tile=int(spec.get("sparse_tile", 0)),
    )
    return config, segments


def format_grid_rows(grid) -> list:
    """The JSON snapshot's grid encoding — one '0'/'1' string per row.
    Shared with the transport layer (``serve/transport.py``) so the
    JSON and binary wire paths format from the same fetched array and
    can never drift."""
    return ["".join("1" if v else "0" for v in row)
            for row in np.asarray(grid, dtype=np.uint8)]


def parse_grid_rows(rows) -> np.ndarray:
    """Inverse of :func:`format_grid_rows` for board writes: a list of
    '0'/'1' strings (or of 0/1 int lists) to a uint8 array.  Ragged or
    non-binary input is a :class:`ConfigError` (HTTP 400)."""
    if not isinstance(rows, list) or not rows:
        raise ConfigError("grid must be a non-empty list of rows")
    try:
        arr = np.array([[int(c) for c in row] for row in rows],
                       dtype=np.uint8)
    except (TypeError, ValueError) as e:
        raise ConfigError(f"grid rows must be '0'/'1' strings or 0/1 "
                          f"lists: {e}")
    if arr.ndim != 2:
        raise ConfigError("grid rows must all have the same length")
    if arr.max(initial=0) > 1:
        raise ConfigError("grid cells must be 0 or 1")
    return arr


def _normalize_timeout(timeout_s: Optional[float]) -> Optional[float]:
    """The one timeout convention, in one place: ``None`` means "no
    explicit value" and any ``<= 0`` means "disable the budget" — both
    normalize to ``None``.  Every budget entry point (manager default,
    create, the blocking verbs via ``_budget``, ticket enqueue) goes
    through here so the convention cannot drift between paths."""
    if timeout_s is not None and timeout_s <= 0:
        return None
    return timeout_s


class _Deadline:
    """A monotonic countdown; ``seconds=None`` never expires."""

    __slots__ = ("t0", "seconds")

    def __init__(self, seconds: Optional[float]):
        self.t0 = time.monotonic()
        self.seconds = None if seconds is None else max(0.0, float(seconds))

    def remaining(self) -> Optional[float]:
        if self.seconds is None:
            return None
        return max(0.0, self.seconds - (time.monotonic() - self.t0))

    def expired(self) -> bool:
        r = self.remaining()
        return r is not None and r <= 0


def _watchdog_call(fn, deadline: _Deadline, label: str, workers=None):
    """Run ``fn`` under the dispatch watchdog: with no budget it runs
    inline (zero overhead); with one, it runs in a daemon worker thread
    and a timeout raises :class:`DeadlineError` in the caller while the
    worker is *abandoned* — Python threads cannot be killed, but an
    abandoned worker merely finishes (or wedges) in the background holding
    the session lock, which later requests see as their own clean deadline
    timeouts rather than a stuck handler.  ``workers``, a set, holds each
    worker while it runs (``SessionManager.shutdown`` joins them)."""
    budget = deadline.remaining()
    if budget is None:
        return fn()
    box = {}
    done = threading.Event()
    # carry the caller's context (the per-request id contextvar) into the
    # worker, so spans recorded under the watchdog still tag the request
    ctx = contextvars.copy_context()

    def run():
        try:
            box["result"] = ctx.run(fn)
        except BaseException as e:  # noqa: BLE001 — re-raised in the caller
            box["error"] = e
        finally:
            done.set()
            if workers is not None:
                workers.discard(threading.current_thread())

    t = threading.Thread(target=run, daemon=True, name=f"watchdog:{label}")
    if workers is not None:
        workers.add(t)
    t.start()
    if not done.wait(budget):
        raise DeadlineError(
            f"{label} exceeded its {deadline.seconds:.3g}s budget "
            f"(dispatch abandoned to the watchdog; the session survives)")
    if "error" in box:
        raise box["error"]
    return box["result"]


class Session:
    """One live board.  ``engine`` is set for cuda sessions (grid is a
    device tensor); host backends keep a numpy grid and a ``stepper(grid,
    n) -> grid`` closure instead.  All mutation goes through ``lock`` —
    the HTTP server is threaded and two requests against one board must
    serialize (two requests against two boards must not)."""

    def __init__(self, sid: str, config: GolConfig, *, engine=None,
                 stepper=None, grid=None, cache_hit: bool = False,
                 setup_s: float = 0.0, plan_sig=None):
        self.id = sid
        self.config = config
        self.engine = engine
        self.stepper = stepper
        self.grid = grid
        self.cache_hit = cache_hit
        self.plan_sig = plan_sig        # batch-queue key (cuda sessions)
        self.generation = 0
        self.batched_steps = 0          # steps served by a coalesced batch
        self.setup_s = setup_s          # plan + compile (grows if a step
        self.steady_s = 0.0             # needs a new depth); stepping time
        self.lock = threading.Lock()
        self.closed = False
        # fault-tolerance state
        self.spec: Optional[dict] = None    # normalized create body (persistence)
        self.ckpt: Optional[dict] = None    # last encoded grid snapshot
        self.degraded = False               # serving via serial_np fallback
        self.degraded_reason: Optional[str] = None
        self.restored = False               # rebuilt by replay after restart
        self.last_error: Optional[str] = None
        # admission-control tags: the owning tenant and the
        # tenant-default priority class.  Both stay None on an unarmed
        # server — describe() and the batch key then behave exactly as
        # before admission existed.
        self.tenant: Optional[str] = None
        self.qos: Optional[str] = None

    def throughput(self) -> dict:  # lint: disable=lock-discipline -- scrape-time racy read: plain attribute loads, atomic under the GIL
        gens = self.generation
        cells = self.config.cells
        return {
            "generations": gens,
            "steady_s": round(self.steady_s, 6),
            "setup_s": round(self.setup_s, 6),
            "gens_per_s": (gens / self.steady_s) if self.steady_s > 0 else None,
            "cell_updates_per_s": (gens * cells / self.steady_s)
            if self.steady_s > 0 else None,
        }


class SessionManager:
    """Owns the session table, the engine cache, the microbatcher, and
    the fault-tolerance machinery: the state store, the fault injector,
    the per-signature breakers (in the cache), and the degradation path.

    One device, ``device`` (the GPU when None; tests pass ``"cpu"``, which
    steps the kernels' plain versions): every cuda session's engine is
    built there.  ``shutdown`` stops the manager's threads (the dispatch
    loop, running watchdog workers) and keeps the state dir's records.

    ``batching=False`` (or ``batch_window_ms=0`` with no concurrency)
    steps every request solo; engine-backed steps otherwise route through
    the :class:`~mpi_tpu_torch.serve.batch.MicroBatcher`.
    """

    def __init__(self, cache: Optional[EngineCache] = None, *,
                 batching: bool = True, batch_window_ms: float = 2.0,
                 batch_max: int = 8,
                 async_enabled: bool = True,
                 async_queue_max: int = 1024,
                 ticket_ttl_s: float = 600.0,
                 state_dir: Optional[str] = None,
                 checkpoint_every: int = 64,
                 state_degrade: str = "continue",
                 state_journal: bool = True,
                 journal_max_bytes: int = 1 << 20,
                 journal_max_age_s: float = 300.0,
                 state_keep: int = 2,
                 request_timeout_s: Optional[float] = None,
                 step_retries: int = 2,
                 retry_backoff_s: float = 0.05,
                 degrade: bool = True,
                 faults=None,
                 obs=None,
                 tune_cache=None,
                 device=None):
        self.obs = obs                  # mpi_tpu_torch.obs.Obs or None (off)
        if tune_cache is not None:
            raise ConfigError("autotuned plans (tune_cache) are ROADMAP "
                              "queue 1 item 12")
        self.device = device
        self._workers = set()           # running watchdog workers
        self.cache = cache if cache is not None else EngineCache()
        self.batcher = (
            MicroBatcher(window_ms=batch_window_ms, max_batch=batch_max)
            if batching else None
        )
        # the async ticket path (opt-in per request; --no-async removes
        # it entirely).  The dispatch-loop thread starts lazily on the
        # first enqueue, so a sync-only workload never runs it.
        self.dispatcher = (
            AsyncDispatcher(self, window_s=max(0.0, batch_window_ms) / 1e3,
                            queue_max=async_queue_max,
                            ticket_ttl_s=ticket_ttl_s)
            if async_enabled else None
        )
        self._sessions: Dict[str, Session] = {}
        self._lock = threading.Lock()
        self._next = 0
        # cluster membership (the reference's cluster package): None
        # means single-process mode — every cluster seam below is a no-op
        self.cluster = None
        # admission control (the reference's admission package): None (the
        # default) keeps every admission seam a no-op
        self.admission = None
        # fault tolerance
        self.request_timeout_s = _normalize_timeout(request_timeout_s)
        if step_retries < 0:
            raise ValueError(f"step_retries must be >= 0, got {step_retries}")
        self.step_retries = int(step_retries)
        self.retry_backoff_s = max(0.0, float(retry_backoff_s))
        self.degrade = bool(degrade)
        # degradation moves a session to the host oracle.  On the card
        # only an injected fault may lead there: the signatures whose
        # breaker counts a real failure of a card engine (a build, a
        # launch, a watchdog timeout) answer EngineUnavailableError
        self._on_card = device is None or str(device).startswith("cuda")
        self._card_failures: set = set()
        if isinstance(faults, str):
            from mpi_tpu_torch.serve.faults import FaultInjector

            faults = FaultInjector.from_spec(faults)
        self.faults = faults
        # --state-degrade policy: what to do with session verbs while
        # persistence is degraded.  "continue" (default) keeps serving
        # and re-checkpoints when the disk heals; "readonly" refuses
        # mutating verbs (503 + Retry-After); "shed" refuses all
        # session verbs so a balancer drains this node
        if state_degrade not in ("continue", "readonly", "shed"):
            raise ValueError(
                f"state_degrade must be continue|readonly|shed, "
                f"got {state_degrade!r}")
        self.state_degrade = state_degrade
        self.store = (recovery.StateStore(
            state_dir, checkpoint_every,
            journal=state_journal,
            journal_max_bytes=journal_max_bytes,
            journal_max_age_s=journal_max_age_s,
            keep=state_keep)
            if state_dir else None)
        if self.store is not None:
            self.store.obs = obs
            if self.faults is not None:
                # the io fault sites fire inside StateStore._io — the
                # one choke point every persisted byte flows through
                self.store.fault_hook = self.faults.io_hook
        self.engine_failures = 0
        self.watchdog_timeouts = 0
        self.degraded_total = 0
        self.restored_sessions = 0
        self.restore_errors = 0
        self.store_errors = 0
        self._last_dispatch_ok: Optional[float] = None
        if self.obs is not None:
            self.obs.bind_manager(self)
        if self.store is not None:
            self._restore_all()

    # -- lifecycle ---------------------------------------------------------

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Stop the async dispatch loop and wait (up to ``timeout_s`` in
        all) for it and for every running watchdog worker; the sessions'
        durable records stay, so a new manager over the same state dir
        restores them.  The manager takes no further tickets."""
        t_end = time.monotonic() + max(0.0, timeout_s)
        if self.dispatcher is not None:
            self.dispatcher.stop(timeout_s)
        for t in list(self._workers):
            t.join(max(0.0, t_end - time.monotonic()))

    def checkpoint_now(self, sid: str) -> None:
        """Force a full-snapshot checkpoint at the session's CURRENT
        generation (the degraded store's retry path).  Raises
        ``KeyError`` for unknown sids."""
        session = self.get(sid)
        if self.store is None:
            return
        with session.lock:
            if session.engine is not None:
                if self._sharded(session.engine):
                    # per-shard checkpoint: each device shard is
                    # fetched and packed independently — no full-board
                    # host array
                    tiles = session.engine.shard_snapshots(session.grid)
                    self._persist(session, shards=tiles, raise_errors=True)
                    return
                grid_np = session.engine.fetch(session.grid)
            else:
                grid_np = np.asarray(session.grid, dtype=np.uint8)
            # a recovery checkpoint MUST land or visibly fail: the
            # caller keeps the session pending until it does
            self._persist(session, grid_np, raise_errors=True)

    def persistence_retry(self) -> None:
        """Flush the degraded-store backlog when the retry backoff has
        elapsed (called from lock-free seams: the top of ``step`` and
        ``health``).  Each pending session gets a fresh full-snapshot
        checkpoint — the write that failed may have been a journal
        entry whose in-memory diff base is long gone.  The first write
        is the probe; if the disk is still sick the store re-arms its
        backoff and this returns quietly."""
        store = self.store
        if store is None or not store.retry_ready():
            return
        try:
            store.retry_deletes()
        except OSError:
            return
        for sid in store.take_pending():
            try:
                self.checkpoint_now(sid)
            except KeyError:
                store.discard_pending(sid)  # released/closed meanwhile
            except OSError:
                return                  # still sick; backoff re-armed

    def _storage_gate(self, mutating: bool = True) -> None:
        """Enforce ``--state-degrade`` while persistence is degraded:
        ``readonly`` refuses mutating session verbs, ``shed`` refuses
        all of them (``continue``, the default, refuses nothing).  The
        transport maps the raise to a structured 503 with Retry-After
        sized by the store's backoff."""
        store = self.store
        if store is None or self.state_degrade == "continue":
            return
        if not store.is_degraded():
            return
        if self.state_degrade == "shed" or mutating:
            wait = max(store.retry_in_s(), 0.5)
            raise recovery.StorageDegradedError(
                f"persistence degraded and --state-degrade is "
                f"{self.state_degrade}; retry in {wait:.1f}s", wait)

    def session_ids(self) -> list:
        with self._lock:
            return list(self._sessions)

    def create(self, spec: dict, timeout_s: Optional[float] = None,
               sid: Optional[str] = None,
               tenant: Optional[str] = None) -> dict:
        """Create a board.  ``timeout_s`` (explicit only — the default
        budget deliberately does NOT cover create: a cold create of a new
        rule legitimately spends seconds in nvcc, and an abandoned create
        worker would still register its session) bounds the build.
        ``sid`` forces the session id (cluster mode: the front that took
        the request allocates the id so ring placement and id agree);
        None keeps the local ``s<n>`` allocation.  ``tenant`` (armed
        admission only) owns the session: its concurrency cap gates the
        create, and every step settles against its quota window."""
        deadline = _Deadline(_normalize_timeout(timeout_s))
        return _watchdog_call(lambda: self._create(spec, sid=sid,
                                                   tenant=tenant),
                              deadline, "create", self._workers)

    def _create(self, spec: dict, sid: Optional[str] = None,
                tenant: Optional[str] = None) -> dict:
        self._storage_gate(mutating=True)
        config, segments = _parse_spec(spec)
        adm = self.admission
        if adm is not None:
            # cap check BEFORE the build — a rejected tenant must not
            # spend compile time (enforcement precedes device work)
            tenant = tenant if tenant is not None else adm.resolve(None)
            adm.admit_session(tenant)
        t0 = time.perf_counter()
        with _span(self.obs, "create", backend=config.backend,
                   rows=config.rows, cols=config.cols):
            if config.backend == "cuda":
                session = self._create_cuda(config, segments)
            else:
                session = self._create_host(config)
        session.setup_s = time.perf_counter() - t0
        session.spec = dict(spec)
        with self._lock:
            if sid is None:
                self._next += 1
                sid = f"s{self._next}"
            elif sid in self._sessions:
                raise ConfigError(f"session id {sid!r} already exists")
            session.id = sid
            self._sessions[sid] = session
        if adm is not None:
            session.tenant = tenant
            session.qos = adm.registry.get(tenant)["default_class"]
            adm.gate.note_session(sid, tenant)
        self._persist(session)
        info = self.describe(session)
        info["cache"] = self.cache.stats()
        return info

    def _create_cuda(self, config: GolConfig, segments,
                     initial=None) -> Session:
        from mpi_tpu_torch.backends.cuda import build_engine

        sig = plan_signature(config, MESH_SHAPE, segments)
        if not self.cache.breaker_allows(sig):
            # quarantined plan: never hand a fresh board to a sick engine
            if not self._may_degrade(sig):
                raise EngineUnavailableError(
                    "engine circuit breaker open for this plan signature "
                    f"and {self._no_degrade_reason()}")
            session = self._degraded_host_session(config, initial=initial)
            session.plan_sig = sig
            return session
        engine, hit = self.cache.get_or_build(
            sig, lambda: build_engine(config, device=self.device))
        if self.faults is not None:
            # idempotent: cached engines get the same hook re-installed
            engine.fault_hook = self.faults.engine_hook
        # same idempotent-install idiom: a cached engine follows THIS
        # manager's obs setting (None detaches a previous manager's)
        engine.obs = self.obs
        # the compact plan tag keys the engine's cost cards and the usage
        # ledger's per-signature series (bounded cardinality: signatures,
        # never sessions)
        engine.sig_label = signature_label(sig)
        grid = engine.init_grid(initial=initial, seed=config.seed)
        # warm the requested segment set (a no-op on a cache hit — the
        # signature pins the set, so the hit engine already has it)
        engine.compile_segments(grid, segments)
        return Session("?", config, engine=engine, grid=grid, cache_hit=hit,
                       plan_sig=sig)

    def _create_host(self, config: GolConfig) -> Session:
        """A session on a host backend the spec named: the numpy oracle
        (``serial``) or the native engine (``cpp``, ``cpp-par``).  Only an
        explicit backend lands here; a degraded card session takes
        :meth:`_degraded_host_session`'s oracle instead."""
        rule, boundary = config.rule, config.boundary
        if config.backend == "serial":
            def stepper(g, n):
                return evolve_np(g, n, rule, boundary)
        elif config.backend == "cpp":
            from mpi_tpu_torch.backends.cpp import evolve_cpp, load_library

            load_library()              # build/dlopen is setup, like a build

            def stepper(g, n):
                return evolve_cpp(g, n, rule, boundary)
        else:  # cpp-par
            from mpi_tpu_torch.backends.cpp import (
                evolve_par_cpp, load_library, plan_tiles,
            )

            load_library()
            tiles = plan_tiles((config.rows, config.cols), config.workers,
                               rule.radius)

            def stepper(g, n):
                return evolve_par_cpp(g, n, rule, boundary, tiles=tiles)

        grid = init_tile_np(config.rows, config.cols, config.seed)
        return Session("?", config, stepper=stepper, grid=grid)

    def _degraded_host_session(self, config: GolConfig, initial=None,
                               reason: str = "circuit breaker open at create",
                               ) -> Session:
        """A session born degraded: the oracle stepper over a numpy grid
        (bit-identical to the engine it stands in for)."""
        rule, boundary = config.rule, config.boundary

        def stepper(g, n):
            return evolve_np(g, n, rule, boundary)

        if callable(initial):
            # a shard-form restore hands a region loader; the host
            # oracle needs the assembled board
            initial = initial(0, config.rows, 0, config.cols)
        grid = (np.asarray(initial, dtype=np.uint8) if initial is not None
                else init_tile_np(config.rows, config.cols, config.seed))
        session = Session("?", config, stepper=stepper, grid=grid)
        session.degraded = True
        session.degraded_reason = reason
        self.degraded_total += 1
        return session

    def close(self, sid: str, timeout_s: Optional[float] = None) -> dict:
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(lambda: self._close(sid), deadline,
                              f"close({sid})", self._workers)

    def _close(self, sid: str) -> dict:
        with self._lock:
            session = self._sessions.pop(sid, None)
        if session is None:
            raise KeyError(sid)
        with session.lock:
            session.closed = True
            session.grid = None         # free device/host buffers now; the
            session.engine = None       # cached engine survives for reuse
        if self.admission is not None:
            self.admission.gate.drop_session(sid)
        if self.store is not None:
            self.store.delete(sid)
        return {"id": sid, "closed": True}

    def get(self, sid: str) -> Session:
        with self._lock:
            session = self._sessions.get(sid)
        if session is None:
            raise KeyError(sid)
        return session

    # -- checkpoint / restore ---------------------------------------------

    @staticmethod
    def _sharded(engine) -> bool:
        """True when the engine spans more than one device shard — the
        cue to checkpoint shard-by-shard instead of through one
        full-board host array (sparse engines are always 1x1, so the
        shard path never sees a SparseState)."""
        return engine is not None and engine.mi * engine.mj > 1

    def _persist(self, session: Session, grid_np=None,  # lint: disable=lock-discipline -- caller holds session.lock (step path) or the session is pre-publication (create/restore)
                 raise_errors: bool = False, shards=None) -> None:
        """Write the session's full durable record (caller holds the
        session lock on the step path; create/restore call it
        pre-publication).  ``grid_np``: a freshly fetched host grid to
        snapshot; ``shards``: ``[(r0, c0, tile), ...]`` device-shard
        tiles to snapshot in shard form (never assembled); None for both
        keeps the previous snapshot.  Store failures are counted, noted,
        and swallowed — durability must degrade, not take the step down
        with it — unless ``raise_errors`` (``checkpoint_now``: a pending
        session stays pending until its checkpoint lands)."""
        if self.store is None or session.spec is None:
            return
        try:
            t0 = time.perf_counter()
            if shards is not None:
                snap = recovery.encode_grid_shards(
                    shards, session.config.rows, session.config.cols)
                snap["generation"] = session.generation
                session.ckpt = snap
            elif grid_np is not None:
                snap = recovery.encode_grid(grid_np)
                snap["generation"] = session.generation
                session.ckpt = snap
            self.store.save(session.id, session.spec, session.generation,
                            session.ckpt)
            if self.obs is not None:
                dt = time.perf_counter() - t0
                self.obs.checkpoint_write.observe(dt)
                self.obs.event("checkpoint_write", dt, t0, sid=session.id,
                               generation=session.generation,
                               snapshot=(grid_np is not None
                                         or shards is not None))
        except recovery.StorageDegradedError:
            # fast-fail while degraded: already queued as pending and
            # counted by the store; no stderr spam per skipped write
            if raise_errors:
                raise
        except Exception as e:  # noqa: BLE001 — durability is best-effort
            self.store_errors += 1
            print(f"note: state-dir write failed for {session.id}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            if raise_errors:
                raise

    def _checkpoint(self, session: Session) -> None:  # lint: disable=lock-discipline -- caller holds session.lock (documented contract)
        """Persist a committed step (caller holds ``session.lock``).
        The generation lands every step — as an appended journal entry
        when journaling (a content delta when the grid rode along, a
        bare mark otherwise; the store compacts to a full record on its
        size/age triggers), as a full record rewrite otherwise.  The
        grid is fetched only every ``checkpoint_every`` generations
        (fetching the device grid is a sync)."""
        if self.store is None or session.spec is None:
            return
        grid_np = None
        tiles = None
        last = session.ckpt["generation"] if session.ckpt else 0
        if session.generation - last >= self.store.checkpoint_every:
            try:
                if session.engine is not None:
                    if self._sharded(session.engine):
                        # shard-form fetch: one host tile per device
                        # shard, packed independently downstream — the
                        # journal then appends only the CHANGED shards
                        tiles = session.engine.shard_snapshots(
                            session.grid)
                    else:
                        grid_np = session.engine.fetch(session.grid)
                else:
                    grid_np = np.asarray(session.grid, dtype=np.uint8)
            except Exception as e:  # noqa: BLE001 — snapshot is an optimization
                self.store_errors += 1
                print(f"note: checkpoint fetch failed for {session.id}: "
                      f"{type(e).__name__}: {e}", file=sys.stderr)
                grid_np = None
                tiles = None
        try:
            t0 = time.perf_counter()
            if tiles is not None:
                snap = recovery.encode_grid_shards(
                    tiles, session.config.rows, session.config.cols)
                snap["generation"] = session.generation
                session.ckpt = snap
            elif grid_np is not None:
                snap = recovery.encode_grid(grid_np)
                snap["generation"] = session.generation
                session.ckpt = snap
            info = self.store.commit_step(
                session.id, session.spec, session.generation, session.ckpt,
                grid=grid_np,
                shards=None if tiles is None else
                (session.config.rows, session.config.cols, tiles))
            if self.obs is not None:
                dt = time.perf_counter() - t0
                if info["form"] == "journal":
                    self.obs.event("journal_append", dt, t0,
                                   sid=session.id,
                                   generation=session.generation,
                                   kind=info["kind"],
                                   bytes=info["bytes"])
                else:
                    self.obs.checkpoint_write.observe(dt)
                    self.obs.event("checkpoint_write", dt, t0,
                                   sid=session.id,
                                   generation=session.generation,
                                   snapshot=grid_np is not None)
        except recovery.StorageDegradedError:
            pass                        # queued as pending; retried later
        except Exception as e:  # noqa: BLE001 — durability is best-effort
            self.store_errors += 1
            print(f"note: state-dir write failed for {session.id}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)

    def _restore_all(self) -> None:
        for rec in self.store.load_records():
            try:
                self._restore_one(rec)
            except Exception as e:  # noqa: BLE001 — salvage the rest
                self.restore_errors += 1
                print(f"note: could not restore session "
                      f"{rec.get('id')!r}: {type(e).__name__}: {e}",
                      file=sys.stderr)
        if self.restored_sessions:
            print(f"[mpi_tpu_torch] restored {self.restored_sessions} "
                  f"session(s) from {self.store.state_dir}", file=sys.stderr)

    def _restore_one(self, rec: dict) -> None:  # lint: disable=lock-discipline -- pre-publication: the session is not in the table yet, no other thread can reach it
        config, segments = _parse_spec(rec["spec"])
        target_gen = int(rec["generation"])
        snap = rec.get("snapshot")
        start_gen = int(snap["generation"]) if snap else 0
        if not 0 <= start_gen <= target_gen:
            raise ValueError(
                f"snapshot generation {start_gen} outside 0..{target_gen}")
        t0 = time.perf_counter()
        if config.backend == "cuda":
            # restore through a region loader, as the reference does (one
            # device: the engine loads the whole board through it)
            initial = recovery.snapshot_loader(snap) if snap else None
            session = self._create_cuda(config, segments, initial=initial)
        else:
            initial = recovery.decode_grid(snap) if snap else None
            session = self._create_host(config)
            if initial is not None:
                session.grid = initial
        session.generation = start_gen
        # deterministic replay to the recorded generation: stepping is a
        # pure function of (grid, n) and every backend is bit-identical
        # to the oracle (PARITY.md), so the restored board equals an
        # uninterrupted run.  Engine replay goes in depth-1 chunks — the
        # one depth every session warms — so restore costs launches, never
        # a new depth's warm-up.
        n = target_gen - start_gen
        if n > 0:
            if session.engine is not None:
                session.engine.ensure_compiled(session.grid, 1)
                for _ in range(n):
                    session.grid = session.engine.step(session.grid, 1)
                session.engine.block_until_ready(session.grid)
            else:
                session.grid = session.stepper(session.grid, n)
            session.generation = target_gen
        session.setup_s = time.perf_counter() - t0
        if self.obs is not None:
            self.obs.restore_replay.observe(session.setup_s)
            self.obs.event("restore_replay", session.setup_s, t0,
                           sid=rec["id"], replayed=n,
                           backend=config.backend)
        session.spec = dict(rec["spec"])
        session.ckpt = snap
        session.restored = True
        sid = rec["id"]
        with self._lock:
            session.id = sid
            self._sessions[sid] = session
            self._next = max(self._next, recovery._sid_ordinal(sid))
        if self.admission is not None:
            # records don't carry tenancy; restored boards settle to the
            # default tenant rather than escaping the books entirely
            session.tenant = self.admission.resolve(None)
            session.qos = self.admission.registry.get(
                session.tenant)["default_class"]
            self.admission.gate.note_session(sid, session.tenant)
        self.restored_sessions += 1
        self._persist(session)

    # -- fault handling ----------------------------------------------------

    def _budget(self, timeout_s: Optional[float]) -> Optional[float]:
        if timeout_s is not None:
            return _normalize_timeout(timeout_s)
        return self.request_timeout_s

    def _engine_failure(self, session: Session, sig, err,
                        timeout: bool = False) -> bool:
        """Count one engine failure; returns True when the signature's
        breaker is now open (caller should degrade, not retry)."""
        self.engine_failures += 1
        if timeout:
            self.watchdog_timeouts += 1
        if self._on_card and not isinstance(err, InjectedFault):
            self._card_failures.add(sig)
        session.last_error = f"{type(err).__name__}: {err}"
        if self.obs is not None:
            self.obs.engine_failures.inc()
            self.obs.event("engine_failure", sid=session.id,
                           error=session.last_error, timeout=timeout)
        opened = self.cache.record_failure(sig)
        if opened:
            print(f"note: circuit breaker OPEN for plan of session "
                  f"{session.id} after consecutive engine failures "
                  f"(last: {session.last_error})", file=sys.stderr)
        return opened

    def _engine_success(self, sig) -> None:
        """A committed engine dispatch closes ``sig``'s breaker."""
        self.cache.record_success(sig)
        self._card_failures.discard(sig)

    def _may_degrade(self, sig) -> bool:
        return self.degrade and sig not in self._card_failures

    def _no_degrade_reason(self) -> str:
        return ("degradation is disabled" if not self.degrade else
                "the failure was the card's own (a card session never "
                "moves to the host oracle)")

    def _degrade_session(self, session: Session, reason: str) -> None:  # lint: disable=lock-discipline -- deliberately lock-free: the trigger is a wedged dispatch still holding session.lock; see docstring
        """Swap ``session`` for a serial_np replacement rebuilt by
        deterministic replay at the last *committed* generation.

        Deliberately does NOT take ``session.lock``: the usual trigger is
        a wedged dispatch still holding it.  The replacement is built
        from the durable facts (spec/seed/checkpoint + committed
        generation — plain attribute reads, atomic under the GIL), the
        table entry is swapped under the manager lock, and the old object
        is orphaned: a late-completing worker commits into the orphan,
        which no request can reach anymore."""
        with self._lock:
            if self._sessions.get(session.id) is not session:
                return                  # someone else already swapped it
        grid = self._replay_np(session.config, session.generation,
                               session.ckpt)
        repl = self._degraded_host_session(session.config, initial=grid,
                                           reason=reason)
        repl.generation = session.generation
        repl.plan_sig = session.plan_sig
        repl.spec = session.spec
        repl.ckpt = session.ckpt
        repl.restored = session.restored
        repl.cache_hit = session.cache_hit
        repl.setup_s = session.setup_s
        repl.steady_s = session.steady_s
        repl.batched_steps = session.batched_steps
        repl.last_error = session.last_error
        with self._lock:
            if self._sessions.get(session.id) is not session:
                return
            repl.id = session.id
            self._sessions[session.id] = repl
        session.closed = True           # orphan: late workers see closed
        print(f"note: session {repl.id} degraded to the serial_np oracle "
              f"({reason}); results stay bit-identical, throughput drops",
              file=sys.stderr)
        if self.obs is not None:
            self.obs.event("degrade", sid=repl.id, reason=reason)
        self._persist(repl)

    @staticmethod
    def _replay_np(config: GolConfig, generation: int,
                   ckpt: Optional[dict]) -> np.ndarray:
        """The board at ``generation``, rebuilt on the host oracle from
        the last checkpoint (or the seed).  Never touches the device —
        a failing engine may have corrupted or donated its buffers."""
        if ckpt is not None:
            grid = recovery.decode_grid(ckpt)
            start = int(ckpt["generation"])
        else:
            grid = init_tile_np(config.rows, config.cols, config.seed)
            start = 0
        return evolve_np(grid, generation - start, config.rule,
                         config.boundary)

    def _mark_dispatch_ok(self) -> None:
        self._last_dispatch_ok = time.monotonic()

    def last_dispatch_age_s(self) -> Optional[float]:
        """Seconds since the last committed dispatch, None before the
        first — the freshness SLO's input (and /healthz's age field)."""
        if self._last_dispatch_ok is None:
            return None
        return time.monotonic() - self._last_dispatch_ok

    # -- verbs -------------------------------------------------------------

    def step(self, sid: str, steps: int = 1,
             timeout_s: Optional[float] = None, *,
             _deadline: Optional[_Deadline] = None,
             _use_batcher: bool = True, _unit: bool = False) -> dict:
        """Blocking step.  The underscored keywords are the async
        dispatcher's hooks into this same retry/breaker/watchdog loop:
        ``_deadline`` carries a ticket's enqueue-time budget,
        ``_use_batcher=False`` skips the sync coalescing queue (the one
        dispatch-loop thread can never coalesce with itself), and
        ``_unit=True`` chains depth-1 steps instead of warming a new
        depth.  The sync path never sets any of them."""
        if steps < 1:
            raise ConfigError(f"steps must be >= 1, got {steps}")
        self.persistence_retry()
        self._storage_gate(mutating=True)
        deadline = (_deadline if _deadline is not None
                    else _Deadline(self._budget(timeout_s)))
        attempt = 0
        while True:
            session = self.get(sid)
            sig = session.plan_sig if session.engine is not None else None
            if sig is not None and not self.cache.breaker_allows(sig):
                if not self._may_degrade(sig):
                    raise EngineUnavailableError(
                        f"engine circuit breaker open for session {sid} "
                        f"and {self._no_degrade_reason()}")
                self._degrade_session(session, "circuit breaker open")
                continue                # re-get: now a host-path session
            try:
                result = _watchdog_call(
                    lambda: self._step_entry(session, steps,
                                             use_batcher=_use_batcher,
                                             unit=_unit),
                    deadline, f"step({sid})", self._workers)
            except (KeyError, ConfigError):
                raise
            except DeadlineError as e:
                if sig is not None:
                    self._engine_failure(session, sig, e, timeout=True)
                raise                   # the budget is gone — no retry
            except Exception as e:  # noqa: BLE001 — engine failures only
                if sig is None:
                    raise               # host failures are not retriable
                opened = self._engine_failure(session, sig, e)
                attempt += 1
                if opened:
                    continue            # loop top degrades (or 503s)
                rem = deadline.remaining()
                if attempt > self.step_retries or (rem is not None and rem <= 0):
                    raise EngineStepError(
                        f"engine step failed after {attempt} attempt(s): "
                        f"{type(e).__name__}: {e}") from e
                pause = self.retry_backoff_s * (2 ** (attempt - 1))
                if rem is not None:
                    pause = min(pause, rem)
                if pause > 0:
                    time.sleep(pause)
                continue
            if sig is not None:
                self._engine_success(sig)
            return result

    def _step_entry(self, session: Session, steps: int,
                    use_batcher: bool = True, unit: bool = False) -> dict:
        """One step attempt: the batched path when eligible, else solo
        under the session lock.  Runs inside the watchdog worker when a
        budget is set."""
        if use_batcher and self.batcher is not None \
                and session.engine is not None \
                and session.plan_sig is not None:
            # engine-backed steps coalesce: concurrent same-signature
            # same-depth requests share ONE stacked step; the batcher
            # takes session.lock (leader-side) and falls back to
            # _step_locked when alone or on any batched-path failure
            return self.batcher.submit(self, session, steps)
        obs = self.obs
        if obs is not None:
            t0 = time.perf_counter()
            session.lock.acquire()
            wait = time.perf_counter() - t0
            obs.lock_wait_series.observe(wait)
            if wait >= 1e-3:
                # only a *contended* wait is a trace-worthy fact; the
                # uncontended acquire would just be ring noise
                obs.event("lock_wait", wait, t0, sid=session.id)
        else:
            session.lock.acquire()
        try:
            if session.closed:
                raise KeyError(session.id)
            return self._step_locked(session, steps, unit=unit)
        finally:
            session.lock.release()

    def _step_locked(self, session: Session, steps: int,  # lint: disable=lock-discipline -- caller (_step_entry) holds session.lock for the whole call
                     unit: bool = False) -> dict:
        """The solo step body; caller holds ``session.lock`` (the step
        path via :meth:`_step_entry`, the microbatch leader for
        lone/fallback entries, the async dispatcher's solo fallback —
        the latter with ``unit=True``: chain depth-1 steps instead of
        warming depth ``steps``).

        With obs on, each step's times: ``t1 - t0`` the warm-up check (a
        build on a new depth), ``t2 - t1`` the launches and the wait for
        them to finish (``Engine.block_until_ready``: on the card the
        launches are asynchronous, so only a time that ends after the
        wait is the step's), ``t2 - td`` that wait alone."""
        obs = self.obs
        if session.engine is not None:
            # a depth never seen before is warmed here — that is setup,
            # not stepping; charge it to setup_s so throughput numbers
            # stay honest (same accounting as run_cuda's phases).  The
            # unit path only ever needs depth 1 — the depth every session
            # warms — so it never pays a new depth's warm-up.
            t0 = time.perf_counter()
            session.engine.ensure_compiled(session.grid, 1 if unit else steps)
            t1 = time.perf_counter()
            session.setup_s += t1 - t0
            # step consumes the input buffer: replace the reference, once
            # the launches have run
            if unit:
                grid = session.engine.step_units(session.grid, steps)
            else:
                grid = session.engine.step(session.grid, steps)
            td = time.perf_counter() if obs is not None else 0.0
            session.grid = session.engine.block_until_ready(grid)
            t2 = time.perf_counter()
            session.steady_s += t2 - t1
            if obs is not None:
                # ONE event for the launch+wait pair (block_s splits
                # them at read time) through the pre-bound series
                if unit:
                    obs.event("device_dispatch", t2 - t1, t1,
                              sid=session.id, steps=steps, unit=True,
                              block_s=round(t2 - td, 9))
                else:
                    obs.event("device_dispatch", t2 - t1, t1,
                              sid=session.id, steps=steps,
                              block_s=round(t2 - td, 9))
                if getattr(session.engine, "tuned_plan", None):
                    obs.dispatch_solo_tuned.observe(t2 - t1)
                else:
                    obs.dispatch_solo.observe(t2 - t1)
                tel = obs.telemetry
                if tel is not None:
                    tel.dispatch_digest.observe(t2 - t1)
                # usage ledger: one committed wait.  The unit path is a
                # solo chain (ONE wait for `steps` depth-1 steps); its
                # instructions are the depth-1 card times the chain
                # length.  A batched-path failure re-enters here, so
                # fallbacks are counted exactly once — by this site.
                card = session.engine.cost_card(1 if unit else steps)
                flops = 0.0 if card is None else (
                    card.flops * steps if unit else card.flops)
                obs.ledger.record(
                    "unit" if unit else "solo", session.engine.sig_label,
                    t2 - t1,
                    [(session.id, steps, steps * session.config.cells,
                      flops)])
                sa = None
                if session.engine.sparse_plan is not None:
                    # activity readout AFTER the wait (tiny tile-map
                    # reduce + fetch) — the span every sparse step
                    # leaves in the trace
                    sa = session.engine.sparse_stats(session.grid)
                    obs.event("sparse_step", 0.0, t2, sid=session.id,
                              active_tiles=sa["active_tiles"],
                              active_fraction=round(
                                  sa["active_fraction"], 6),
                              mode=sa["mode"])
                fl = obs.flight
                if fl is not None:
                    fl.record("unit" if unit else "solo",
                              engine=session.engine, steps=steps,
                              session=session.id, setup_s=t1 - t0,
                              device_s=t2 - t1, block_s=t2 - td,
                              sparse=sa)
            self._mark_dispatch_ok()
        else:
            t0 = time.perf_counter()
            session.grid = session.stepper(session.grid, steps)
            t1 = time.perf_counter()
            session.steady_s += t1 - t0
            if obs is not None:
                obs.event("host_step", t1 - t0, t0,
                          sid=session.id, steps=steps)
                obs.dispatch_host.observe(t1 - t0)
                tel = obs.telemetry
                if tel is not None:
                    tel.dispatch_digest.observe(t1 - t0)
                # host wall is metered apart from device-seconds (the
                # ledger's host_s bucket); degraded cuda sessions keep
                # their signature row, plain host backends get "-"
                obs.ledger.record(
                    "host",
                    signature_label(session.plan_sig)
                    if session.plan_sig is not None else None,
                    t1 - t0,
                    [(session.id, steps, steps * session.config.cells,
                      0.0)])
                fl = obs.flight
                if fl is not None:
                    fl.record("host", steps=steps, session=session.id,
                              device_s=t1 - t0)
        session.generation += steps
        self._checkpoint(session)
        return {"id": session.id, "generation": session.generation,
                "steps": steps}

    # -- admission -----------------------------------------------------------

    def admission_check(self, sid: str, steps: int,
                        tenant: Optional[str] = None,
                        qos: Optional[str] = None) -> Optional[str]:
        """Gate one step request BEFORE any device work: resolve the
        request's class (tenant default, header override capped at the
        tenant ceiling), run the shed ladder, and charge the CostCard
        estimate against the tenant's remaining window quota.  Returns
        the resolved class (None when admission is unarmed, the port's
        only state until admission is ported).  Raises the admission
        package's ``AdmissionReject`` (429), or
        ``ConfigError`` when the header names a tenant that is not the
        session's owner (accounting must stay honest)."""
        adm = self.admission
        if adm is None:
            return None
        session = self.get(sid)         # unknown session -> 404 first
        owner = session.tenant if session.tenant is not None \
            else adm.resolve(None)
        if tenant:
            claimed = adm.resolve(tenant)
            if claimed != owner:
                raise ConfigError(
                    f"session {sid!r} belongs to tenant {owner!r}, "
                    f"not {claimed!r}")
        resolved = adm.resolve_class(owner, qos)
        est_device_s, est_cells = adm.estimate(session, steps)
        adm.admit_step(owner, resolved, est_device_s, est_cells)
        return resolved

    # -- async (ticketed) stepping ----------------------------------------

    def step_async(self, sid: str, steps: int = 1,
                   timeout_s: Optional[float] = None,
                   qos: Optional[str] = None) -> dict:
        """Enqueue a step and return immediately with a ticket.  The
        budget starts NOW, at enqueue — a ticket that expires while
        queued is drained with :class:`DeadlineError` without ever
        dispatching, and one that expires mid-flight stops advancing at
        the last committed unit round.  ``timeout_s`` follows the same
        convention as every blocking verb (explicit override beats the
        server default; <= 0 disables)."""
        if self.dispatcher is None:
            raise ConfigError("async stepping is disabled (--no-async)")
        if steps < 1:
            raise ConfigError(f"steps must be >= 1, got {steps}")
        self._storage_gate(mutating=True)   # reject at enqueue, not resolve
        session = self.get(sid)         # unknown session -> 404 at enqueue
        deadline = _Deadline(self._budget(timeout_s))
        t0 = time.perf_counter()
        adm = self.admission
        if adm is None:
            ticket = self.dispatcher.submit(sid, steps, deadline)
        else:
            # class + cost tags drive the dispatcher's weighted pick;
            # the admission decision itself already ran (transport) or
            # runs on the tenant default here (direct callers)
            resolved = qos if qos is not None else \
                adm.resolve_class(session.tenant if session.tenant
                                  is not None else adm.resolve(None), None)
            ticket = self.dispatcher.submit(
                sid, steps, deadline, qos=resolved,
                cost=adm.estimate_ops(session, steps))
        if self.obs is not None:
            self.obs.event("enqueue", time.perf_counter() - t0, t0,
                           sid=sid, ticket=ticket.id, steps=steps)
        return {"ticket": ticket.id, "id": sid, "status": "pending"}

    def ticket_result(self, tid: str, wait: bool = False,  # lint: disable=lock-discipline -- ticket status flips exactly once under _cv; a racy read settles via event.wait, terminal states are immutable
                      timeout_s: Optional[float] = None) -> dict:
        """A ticket's current outcome.  ``wait=True`` blocks until the
        ticket resolves (bounded by the usual request budget); a
        resolved-with-error ticket re-raises its stored exception, so
        the HTTP layer maps it to the SAME structured 503/404 the
        blocking path would have answered."""
        if self.dispatcher is None:
            raise KeyError(tid)
        ticket = self.dispatcher.get(tid)
        if wait:
            # the span records how long THIS read blocked — 0 when the
            # ticket had already resolved (emitted either way, so trace
            # tooling sees every waited read, not just the slow ones)
            t0 = time.perf_counter()
            if ticket.status == "pending":
                ticket.event.wait(self._budget(timeout_s))
            if self.obs is not None:
                dt = time.perf_counter() - t0
                self.obs.event("ticket_wait", dt, t0,
                               ticket=tid, sid=ticket.sid,
                               resolved=ticket.status != "pending")
                tel = self.obs.telemetry
                if tel is not None:
                    tel.ticket_wait_digest.observe(dt)
        if ticket.status == "error":
            raise ticket.error
        out = {"ticket": ticket.id, "id": ticket.sid,
               "status": ticket.status}
        if ticket.status == "done":
            out["result"] = ticket.result
        else:
            out["steps"] = ticket.steps
            out["remaining"] = ticket.remaining
        return out

    def snapshot(self, sid: str, timeout_s: Optional[float] = None) -> dict:
        self._storage_gate(mutating=False)
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(lambda: self._snapshot(sid), deadline,
                              f"snapshot({sid})", self._workers)

    def snapshot_array(self, sid: str, timeout_s: Optional[float] = None):
        """``(grid_np, generation, config)`` under the same lock/deadline
        discipline as :meth:`snapshot` — the transport layer's fetch for
        both wire formats (it formats JSON rows or a binary frame from
        the same array, so the two paths cannot disagree)."""
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(lambda: self._snapshot_grid(sid), deadline,
                              f"snapshot({sid})", self._workers)

    def _snapshot_grid(self, sid: str):
        session = self.get(sid)
        with session.lock:
            if session.closed:
                raise KeyError(sid)
            # generation must be captured with the grid, INSIDE the lock —
            # a concurrent step between fetch and return would otherwise
            # label this grid with a later generation (torn read)
            generation = session.generation
            if session.engine is not None:
                grid = session.engine.fetch(session.grid)
                if grid is None:
                    raise ConfigError(
                        "snapshot over HTTP needs single-host execution")
            else:
                grid = session.grid
        return np.asarray(grid, dtype=np.uint8), generation, session.config

    def _snapshot(self, sid: str) -> dict:
        grid, generation, config = self._snapshot_grid(sid)
        return {"id": sid, "generation": generation,
                "rows": config.rows, "cols": config.cols,
                "grid": format_grid_rows(grid)}

    @staticmethod
    def window_rects(x0: int, y0: int, h: int, w: int, rows: int,
                      cols: int, boundary: str):
        """Non-wrapping board rectangles covering a requested window,
        each tagged with its offset inside the output array:
        ``[(out_r, out_c, r0, c0, rh, rw), ...]``.  Periodic boards wrap
        (up to four rectangles); any other boundary requires the window
        to sit fully inside the board."""
        if h < 1 or w < 1:
            raise ConfigError(f"window extent must be >= 1, got {h}x{w}")
        if not (0 <= x0 < rows and 0 <= y0 < cols):
            raise ConfigError(
                f"window origin ({x0},{y0}) is off the {rows}x{cols} board")
        if h > rows or w > cols:
            raise ConfigError(
                f"window {h}x{w} exceeds the {rows}x{cols} board")
        wraps = x0 + h > rows or y0 + w > cols
        if wraps and boundary != "periodic":
            raise ConfigError(
                f"window [{x0}:{x0 + h}, {y0}:{y0 + w}] leaves the "
                f"{rows}x{cols} board and boundary {boundary!r} does "
                f"not wrap")
        r_spans = [(0, x0, min(h, rows - x0))]
        if x0 + h > rows:
            r_spans.append((rows - x0, 0, x0 + h - rows))
        c_spans = [(0, y0, min(w, cols - y0))]
        if y0 + w > cols:
            c_spans.append((cols - y0, 0, y0 + w - cols))
        return [(out_r, out_c, r0, c0, rh, rw)
                for out_r, r0, rh in r_spans
                for out_c, c0, rw in c_spans]

    def snapshot_window(self, sid: str, x0: int, y0: int, h: int, w: int,
                        timeout_s: Optional[float] = None):
        """``(window_np, generation, config)`` for one viewport — the
        O(viewport) read path: only the rows and words the window covers
        cross to the host (``Engine.fetch_window``), never the whole
        board.  A window crossing the periodic wrap is
        decomposed into up to four non-wrapping rectangles.  Same
        lock/deadline discipline as :meth:`snapshot_array`."""
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(
            lambda: self._snapshot_window(sid, x0, y0, h, w), deadline,
            f"snapshot_window({sid})", self._workers)

    def _snapshot_window(self, sid: str, x0: int, y0: int, h: int, w: int):
        session = self.get(sid)
        x0, y0, h, w = int(x0), int(y0), int(h), int(w)
        rects = self.window_rects(x0, y0, h, w, session.config.rows,
                                   session.config.cols,
                                   session.config.boundary)
        obs = self.obs
        timer = None
        fetched = {"n": 0, "s": 0.0}
        if obs is not None:
            series = obs.shard_fetch_series

            def timer(dt_s, _series=series, _f=fetched):
                _f["n"] += 1
                _f["s"] += dt_s
                _series.observe(dt_s)
        with session.lock:
            if session.closed:
                raise KeyError(sid)
            # same torn-read discipline as snapshot: generation leaves
            # the lock with the cells it labels
            generation = session.generation
            out = np.empty((h, w), dtype=np.uint8)
            if session.engine is not None:
                for out_r, out_c, r0, c0, rh, rw in rects:
                    part = session.engine.fetch_window(
                        session.grid, r0, c0, rh, rw, shard_timer=timer)
                    if part is None:
                        raise ConfigError(
                            "viewport over HTTP needs single-host "
                            "execution")
                    out[out_r:out_r + rh, out_c:out_c + rw] = part
            else:
                grid = np.asarray(session.grid, dtype=np.uint8)
                for out_r, out_c, r0, c0, rh, rw in rects:
                    out[out_r:out_r + rh,
                        out_c:out_c + rw] = grid[r0:r0 + rh, c0:c0 + rw]
            fl = obs.flight if obs is not None else None
            if fl is not None:
                fl.record("viewport", engine=session.engine,
                          session=sid, device_s=fetched["s"],
                          window=(x0, y0, h, w),
                          shards_touched=fetched["n"])
        return out, generation, session.config

    def write_board(self, sid: str, grid, generation: Optional[int] = None,
                    timeout_s: Optional[float] = None) -> dict:
        """Overwrite a live board's grid (the board-write endpoint).
        ``generation=None`` keeps the session's current generation;
        an explicit value rebases it (a client uploading a saved world).
        The written grid is persisted as a snapshot checkpoint
        immediately: replay-from-seed is no longer valid once a board
        has been written to, so durability must anchor on the write."""
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(lambda: self._write_board(sid, grid, generation),
                              deadline, f"write_board({sid})", self._workers)

    def _write_board(self, sid: str, grid,
                     generation: Optional[int]) -> dict:
        self._storage_gate(mutating=True)
        session = self.get(sid)
        arr = np.ascontiguousarray(grid, dtype=np.uint8)
        shape = (session.config.rows, session.config.cols)
        if arr.shape != shape:
            raise ConfigError(
                f"grid shape {arr.shape} does not match session "
                f"{shape[0]}x{shape[1]}")
        if arr.max(initial=0) > 1:
            raise ConfigError("grid cells must be 0 or 1")
        with session.lock:
            if session.closed:
                raise KeyError(sid)
            if session.engine is not None:
                # same entry point the restore path uses: the engine
                # re-stages the array (and resets any sparse dirty map)
                session.grid = session.engine.init_grid(
                    initial=arr, seed=session.config.seed)
            else:
                session.grid = arr
            if generation is not None:
                if generation < 0:
                    raise ConfigError(
                        f"generation must be >= 0, got {generation}")
                session.generation = int(generation)
            self._persist(session, grid_np=arr)
            out = {"id": sid, "generation": session.generation,
                   "rows": shape[0], "cols": shape[1], "written": True}
        if self.obs is not None:
            self.obs.event("board_write", sid=sid,
                           generation=out["generation"])
        return out

    def write_window(self, sid: str, x0: int, y0: int, patch,
                     generation: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> dict:
        """Write one region of a live board (the windowed board-write
        endpoint): only the rows and words the patch covers are read,
        edited and written on the device (``Engine.write_window``), so
        concurrent editors of disjoint regions never pay O(board).  ``generation`` follows the same
        rebase seam as :meth:`write_board`.  Like a full write, the
        result is persisted immediately (shard form on sharded
        engines): replay-from-seed is invalid once a board has been
        edited."""
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(
            lambda: self._write_window(sid, x0, y0, patch, generation),
            deadline, f"write_window({sid})", self._workers)

    def _write_window(self, sid: str, x0: int, y0: int, patch,
                      generation: Optional[int]) -> dict:
        self._storage_gate(mutating=True)
        session = self.get(sid)
        arr = np.ascontiguousarray(patch, dtype=np.uint8)
        if arr.ndim != 2:
            raise ConfigError(f"patch must be 2-D, got shape {arr.shape}")
        if arr.max(initial=0) > 1:
            raise ConfigError("grid cells must be 0 or 1")
        x0, y0 = int(x0), int(y0)
        rects = self.window_rects(x0, y0, arr.shape[0], arr.shape[1],
                                   session.config.rows,
                                   session.config.cols,
                                   session.config.boundary)
        with session.lock:
            if session.closed:
                raise KeyError(sid)
            if session.engine is not None:
                grid = session.grid
                for out_r, out_c, r0, c0, rh, rw in rects:
                    part = arr[out_r:out_r + rh, out_c:out_c + rw]
                    grid = session.engine.write_window(grid, r0, c0, part)
                    if grid is None:
                        break
                if grid is not None:
                    session.grid = grid
                else:
                    # sparse engines cannot edit in place (a partial
                    # edit would stale the dirty map): fall back to the
                    # full fetch-edit-reinit path
                    full = session.engine.fetch(session.grid)
                    if full is None:
                        raise ConfigError(
                            "board write over HTTP needs single-host "
                            "execution")
                    for out_r, out_c, r0, c0, rh, rw in rects:
                        full[r0:r0 + rh, c0:c0 + rw] = \
                            arr[out_r:out_r + rh, out_c:out_c + rw]
                    session.grid = session.engine.init_grid(
                        initial=full, seed=session.config.seed)
            else:
                grid = np.array(session.grid, dtype=np.uint8, copy=True)
                for out_r, out_c, r0, c0, rh, rw in rects:
                    grid[r0:r0 + rh, c0:c0 + rw] = \
                        arr[out_r:out_r + rh, out_c:out_c + rw]
                session.grid = grid
            if generation is not None:
                if generation < 0:
                    raise ConfigError(
                        f"generation must be >= 0, got {generation}")
                session.generation = int(generation)
            if self._sharded(session.engine):
                self._persist(session,
                              shards=session.engine.shard_snapshots(
                                  session.grid))
            elif session.engine is not None:
                self._persist(session,
                              grid_np=session.engine.fetch(session.grid))
            else:
                self._persist(session, grid_np=np.asarray(
                    session.grid, dtype=np.uint8))
            out = {"id": sid, "generation": session.generation,
                   "x0": x0, "y0": y0, "rows": int(arr.shape[0]),
                   "cols": int(arr.shape[1]), "written": True}
        if self.obs is not None:
            self.obs.event("board_write", sid=sid,
                           generation=out["generation"], x0=x0, y0=y0,
                           h=int(arr.shape[0]), w=int(arr.shape[1]))
        return out

    def density(self, sid: str, timeout_s: Optional[float] = None) -> dict:
        deadline = _Deadline(self._budget(timeout_s))
        return _watchdog_call(lambda: self._density(sid), deadline,
                              f"density({sid})", self._workers)

    def _density(self, sid: str) -> dict:
        session = self.get(sid)
        with session.lock:
            if session.closed:
                raise KeyError(sid)
            # same torn-read discipline as snapshot: the generation and
            # the population it describes leave the lock together
            generation = session.generation
            if session.engine is not None:
                pop = session.engine.population(session.grid)
            else:
                pop = int(np.asarray(session.grid, dtype=np.int64).sum())
        return {"id": sid, "generation": generation,
                "population": pop,
                "density": pop / session.config.cells}

    # -- introspection -----------------------------------------------------

    def describe(self, session: Session) -> dict:
        # snapshot every field under session.lock: a concurrent close()
        # nulls session.engine, and a concurrent step bumps generation —
        # reading them unlocked can tear (engine checked non-None, then
        # dereferenced as None)
        with session.lock:
            engine = session.engine
            d = {
                "id": session.id,
                "backend": session.config.backend,
                "rows": session.config.rows,
                "cols": session.config.cols,
                "rule": str(session.config.rule),
                "boundary": session.config.boundary,
                "generation": session.generation,
                "throughput": session.throughput(),
            }
            if engine is not None:
                d["cache_hit"] = session.cache_hit
                d["engine_compiles"] = engine.compile_count
                d["engine_batched_compiles"] = engine.batched_compile_count
                d["engine_notes"] = list(engine.notes)
                d["batched_steps"] = session.batched_steps
                if engine.sparse_plan is not None:
                    d["sparse"] = engine.sparse_stats(session.grid)
            if session.degraded:
                d["degraded"] = True
                d["degraded_reason"] = session.degraded_reason
                d["active_backend"] = "serial_np"
            if session.restored:
                d["restored"] = True
            if session.last_error:
                d["last_error"] = session.last_error
            if session.tenant is not None:
                # armed admission only — unarmed payloads are unchanged
                d["tenant"] = session.tenant
                d["class"] = session.qos
        if self.obs is not None:
            # the session's usage-ledger row (process-local metering;
            # absent until the first committed step)
            usage = self.obs.ledger.session_row(session.id)
            if usage is not None:
                d["usage"] = usage
        if self.dispatcher is not None:
            # read AFTER session.lock is released: the dispatch loop
            # takes session locks while holding its own, never reversed
            d["queue_depth"] = self.dispatcher.queued_for(session.id)
            d["tickets_pending"] = self.dispatcher.pending_for(session.id)
            d["tickets_completed"] = self.dispatcher.completed_for(session.id)
        return d

    def _session_list(self):
        with self._lock:
            return list(self._sessions.values())

    def stats(self) -> dict:
        with self._lock:
            sessions = list(self._sessions.values())
        out = {
            "cache": self.cache.stats(),
            "sessions": [self.describe(s) for s in sessions],
        }
        if self.batcher is not None:
            out["batch"] = self.batcher.stats()
        if self.dispatcher is not None:
            out["async"] = self.dispatcher.stats()
        out["breaker"] = self.cache.breaker_stats()
        out["failures"] = {
            "engine_failures": self.engine_failures,
            "watchdog_timeouts": self.watchdog_timeouts,
            "degraded_sessions": sum(1 for s in sessions if s.degraded),
            "degraded_total": self.degraded_total,
            "degrade_fallback": self.degrade,
        }
        if self.store is not None:
            rec = self.store.stats()
            rec["restored_sessions"] = self.restored_sessions
            rec["restore_errors"] = self.restore_errors
            rec["store_errors"] = self.store_errors
            out["recovery"] = rec
        if self.faults is not None:
            out["faults"] = self.faults.stats()
        if self.obs is not None:
            from mpi_tpu_torch.obs.profile import compile_execute_breakdown

            obs_stats = self.obs.stats()
            obs_stats["breakdown"] = compile_execute_breakdown(self)
            obs_stats["usage"] = self.obs.ledger.totals()
            out["obs"] = obs_stats
        return out

    def usage(self) -> dict:
        """The usage payload (the reference's ``GET /usage``): ledger
        totals, per-session rows, and per-signature rows joined with each
        live engine's cost cards and a roofline readout (achieved cells/s
        over the cost-model bound, present only where there is a roof:
        on the card, or with ``MPI_TPU_ROOF_OPS_PER_S``).  Raises
        :class:`RuntimeError` when obs is off.

        The ledger is process-local: a restart (or restore-from-
        checkpoint) starts metering from zero, by design."""
        if self.obs is None:
            raise RuntimeError("usage metering needs observability")
        from mpi_tpu_torch.obs.cost import ops_per_cell_detail, roof_ops_per_s
        from mpi_tpu_torch.obs.profile import _live_engines

        roof = roof_ops_per_s()
        ledger = self.obs.ledger
        signatures = ledger.signature_rows()
        by_label = {}
        for eng in _live_engines(self):
            label = getattr(eng, "sig_label", None)
            if label is not None and label not in by_label:
                by_label[label] = eng
        sig_rows = []
        for label in sorted(signatures):
            row = dict(signatures[label], signature=label)
            eng = by_label.get(label)
            if eng is not None:
                cards = eng.cost_cards()
                row["cost_cards"] = [c.as_dict() for c in cards]
                ops_per_cell, suspect = ops_per_cell_detail(
                    cards, eng.config.cells)
                if getattr(eng, "tuned_plan", None):
                    row["tuned_plan"] = dict(eng.tuned_plan)
                if (roof is not None and ops_per_cell is not None
                        and row["device_s"] > 0):
                    bound = roof / ops_per_cell
                    achieved = row["cells"] / row["device_s"]
                    row["roofline"] = {
                        "ops_per_cell": ops_per_cell,
                        "bound_cells_per_s": bound,
                        "achieved_cells_per_s": achieved,
                        "efficiency": achieved / bound,
                        # the estimate came from depth>1 cards alone
                        "trip_count_suspect": suspect,
                    }
            sig_rows.append(row)
        out = {
            "totals": ledger.totals(),
            "sessions": ledger.session_rows(),
            "signatures": sig_rows,
            "roof_ops_per_s": roof,
            "note": "process-local: restarts and restores reset nothing "
                    "but start metering from zero",
        }
        if self.cluster is not None:
            # slice-wide roll-up: local totals + each peer's latest
            # gossiped snapshot (exact sums, at most one interval stale)
            out["cluster"] = self.cluster.usage_rollup()
        if self.admission is not None:
            # spend vs quota, live sessions, class mix per tenant —
            # absent (not empty) on unarmed managers
            out["tenants"] = self.admission.tenants_block()
        return out

    def slo(self) -> dict:
        """The SLO payload (the reference's ``GET /slo``): the engine's
        full snapshot (states, burn rates, window summaries) plus the
        cluster roll-up when a node is attached.  Raises
        :class:`RuntimeError` when obs is off or telemetry is unarmed."""
        if self.obs is None or self.obs.slo is None:
            raise RuntimeError(
                "SLO evaluation needs armed telemetry (Obs.arm_telemetry)")
        out = self.obs.slo.snapshot()
        if self.cluster is not None:
            # slice-wide roll-up: local compact state + each peer's
            # latest gossiped snapshot (same discipline as usage)
            out["cluster"] = self.cluster.slo_rollup()
        return out

    def health(self) -> dict:
        """The deep ``/healthz`` payload.  ``ok`` is False — the probe
        answers 503 — exactly when the service is degraded with no
        fallback: some breaker is open and degradation is disabled (or
        the card's own failure opened it), so requests on those plans
        cannot be served at all."""
        self.persistence_retry()        # the probe rides health checks too
        with self._lock:
            sessions = list(self._sessions.values())
        br = self.cache.breaker_stats()
        ok = not (br["open"] and (not self.degrade or self._card_failures))
        age = self.last_dispatch_age_s()
        age = round(age, 3) if age is not None else None
        out = {
            "ok": ok,
            "sessions": len(sessions),
            "tickets_pending": (self.dispatcher.pending()
                                if self.dispatcher is not None else 0),
            "degraded_sessions": sum(1 for s in sessions if s.degraded),
            "restored_sessions": self.restored_sessions,
            "breaker": {"open": br["open"], "half_open": br["half_open"],
                        "trips": br["trips"]},
            "degrade_fallback": self.degrade,
            "last_dispatch_ok_age_s": age,
            "state_dir": self.store.state_dir if self.store else None,
            "faults_injected": (sum(self.faults.injected.values())
                                if self.faults is not None else 0),
        }
        if self.store is not None:
            # the closed->degraded->recovering state machine, pending
            # backlog, and seconds to the next disk probe — always in
            # the body.  "ok" flips only when the degrade policy blocks
            # verbs (readonly/shed): under "continue" the node still
            # serves everything, and a 503 would make a balancer evict
            # a node that is working as designed
            pers = self.store.persistence_state()
            out["persistence"] = pers
            if pers["state"] == "degraded" \
                    and self.state_degrade != "continue":
                out["ok"] = False
        if self.cluster is not None:
            # peer liveness from gossip heartbeats.  Deliberately not
            # folded into "ok": a down peer makes ITS sessions 404, but
            # this process still serves everything it owns
            out["cluster"] = self.cluster.health_block()
            if self.cluster.draining:
                # drain flips the PROBE to 503 (the transport keys on
                # this) while the node keeps serving/proxying — exactly
                # what a load balancer needs to rotate it out
                out["draining"] = True
        if self.obs is not None and self.obs.slo is not None:
            # alerting, not readiness: a burning SLO (even critical
            # availability) never flips "ok" — the probe keys readiness
            # on degraded-without-fallback, and restarting a process
            # because its error budget is gone only burns it faster
            out["slo"] = self.obs.slo.health_block()
        return out

    def __len__(self) -> int:
        with self._lock:
            return len(self._sessions)
