"""``mpi_tpu_torch.obs`` — tracing, metrics, and profiling for the serve
stack.

One :class:`Obs` object bundles the channels and is threaded through the
layers as a single optional handle (``SessionManager(obs=...)`` → batcher,
engines, recovery):

* **spans/events** (:mod:`.trace`, :mod:`.tracectx`) — a request's
  lifecycle, end-to-end by shared request id: session lock wait → batch
  window → ``ensure_compiled`` (a kernel build and warm-up on a miss) →
  the step's launches → ``Engine.block_until_ready`` → checkpoint write.
  Ring-buffered always; streamed as JSONL with ``trace_log``.
* **metrics** (:mod:`.metrics`) — push-style histograms/counters for the
  hot-path quantities (step latency, batch occupancy, build wall,
  checkpoint/restore time) plus scrape-time callbacks over state that
  already lives elsewhere (breaker/cache/queue/engine counters), rendered
  as Prometheus text by :meth:`Obs.render_metrics`, under the reference's
  family names, label sets and help strings.
* **usage and cost** (:mod:`.ledger`, :mod:`.cost`) — device-seconds,
  generations, cells and instructions per session and per plan signature,
  the instructions from cost cards built from the kernels' own counts.
* **profiling** (:mod:`.profile`) — ``torch.profiler`` device traces of
  live traffic and the compile-vs-execute regime breakdown in
  ``SessionManager.stats()``.
* armed on demand: telemetry history and the SLO engine
  (:meth:`Obs.arm_telemetry`), the flight recorder, the anomaly detector
  and the device-memory sampler (:meth:`Obs.arm_flight`).

``obs=None`` everywhere means OFF: every instrumentation site guards on
the handle, so the uninstrumented path runs as if obs did not exist.
Obs only reads what happened: it never catches a kernel's or an engine's
failure and never changes which device or engine steps a board.  Every
step time it records on the card ends after the launches it covers have
run (``Engine.block_until_ready``), never at their enqueue.
"""

from __future__ import annotations

from typing import Optional

from mpi_tpu_torch.obs.ledger import UsageLedger
from mpi_tpu_torch.obs.metrics import (
    COMPILE_BUCKETS, IO_BUCKETS, LATENCY_BUCKETS, OCCUPANCY_BUCKETS,
    MetricsRegistry,
)
from mpi_tpu_torch.obs.trace import (
    Tracer, current_request_id, reset_request_id, set_request_id,
)

__all__ = [
    "Obs", "Tracer", "MetricsRegistry",
    "current_request_id", "set_request_id", "reset_request_id",
]


class Obs:
    """The observability bundle: one tracer + one metrics registry with
    the serve stack's instruments pre-registered (so every layer pokes
    attributes instead of re-declaring names, and `/metrics` has a
    stable schema whether or not traffic has touched a site yet)."""

    def __init__(self, trace_capacity: int = 4096,
                 trace_log: Optional[str] = None,
                 instance: Optional[dict] = None):
        self.tracer = Tracer(capacity=trace_capacity, log_path=trace_log)
        # ``instance`` (cluster mode's host/process identity) becomes
        # constant labels on every rendered sample; None renders nothing
        self.metrics = MetricsRegistry(const_labels=instance)
        # per-session/per-signature usage accounting (obs/ledger.py),
        # fed at the dispatch commit sites; process-local by design
        self.ledger = UsageLedger()
        m = self.metrics
        self.dispatch_latency = m.histogram(
            "mpi_tpu_dispatch_latency_seconds",
            "Device step wall time per call (mode=solo|batched|host)",
            LATENCY_BUCKETS)
        self.batch_occupancy = m.histogram(
            "mpi_tpu_batch_occupancy_boards",
            "Boards per coalesced step dispatch (B)",
            OCCUPANCY_BUCKETS)
        self.compile_wall = m.histogram(
            "mpi_tpu_compile_wall_seconds",
            "Wall time of each real XLA/Mosaic compile",
            COMPILE_BUCKETS)
        self.checkpoint_write = m.histogram(
            "mpi_tpu_checkpoint_write_seconds",
            "Session record write time (tmp+fsync+rename)",
            IO_BUCKETS)
        self.restore_replay = m.histogram(
            "mpi_tpu_restore_replay_seconds",
            "Per-session restore time (rebuild + deterministic replay)",
            IO_BUCKETS)
        self.lock_wait = m.histogram(
            "mpi_tpu_session_lock_wait_seconds",
            "Time a step spent waiting on its session lock",
            LATENCY_BUCKETS)
        self.http_requests = m.counter(
            "mpi_tpu_http_requests_total",
            "HTTP requests by method and status code")
        self.http_bytes_in = m.counter(
            "mpi_tpu_http_bytes_in_total",
            "Request body bytes read, by transport front")
        self.http_bytes_out = m.counter(
            "mpi_tpu_http_bytes_out_total",
            "Response body bytes written, by transport front")
        self.wire_encode = m.histogram(
            "mpi_tpu_wire_encode_seconds",
            "Grid payload encode wall (format=json|binary) per transport",
            IO_BUCKETS)
        self.wire_decode = m.histogram(
            "mpi_tpu_wire_decode_seconds",
            "Grid payload decode wall (format=json|binary) per transport",
            IO_BUCKETS)
        self.engine_failures = m.counter(
            "mpi_tpu_engine_failures_observed_total",
            "Engine dispatch failures seen by the step path")
        # viewport serving: windowed reads, dirty-tile
        # delta streams, per-shard device transfers
        self.viewport_bytes = m.counter(
            "mpi_tpu_viewport_bytes_total",
            "Windowed board-read payload bytes served, by transport front")
        self.delta_frames = m.counter(
            "mpi_tpu_delta_frames_total",
            "Stream frames pushed by kind (kind=key|delta)")
        self.shard_fetch = m.histogram(
            "mpi_tpu_shard_fetch_seconds",
            "Per-device-shard window transfer wall (viewport reads)",
            IO_BUCKETS)
        # pre-bound series handles for the step hot path: observing
        # through these skips the per-call label resolution (~2 µs →
        # ~0.6 µs), and binding them here makes the /metrics schema
        # stable from the first scrape (empty series still render).
        # Step counts are NOT push-counted — the engines' own
        # step_calls/batched_step_calls are scraped at render time
        # (mpi_tpu_engine_counters_total), so the hot path pays nothing
        # for them.
        # telemetry history + SLO engine: None until
        # arm_telemetry() — the unarmed scrape/trace stay byte-identical
        self.telemetry = None
        self.slo = None
        # flight recorder + drift detector + devmem sampler:
        # None until arm_flight() — same unarmed byte-identity contract
        self.flight = None
        self.anomaly = None
        self.devmem = None
        self.dispatch_solo = self.dispatch_latency.series(mode="solo")
        self.dispatch_batched = self.dispatch_latency.series(mode="batched")
        self.dispatch_host = self.dispatch_latency.series(mode="host")
        # tuned-plan dispatches observe through their own series (an
        # added plan="tuned" label): the existing three keep their exact
        # label sets, so dashboards and tests keyed on them never move
        self.dispatch_solo_tuned = self.dispatch_latency.series(
            mode="solo", plan="tuned")
        self.dispatch_batched_tuned = self.dispatch_latency.series(
            mode="batched", plan="tuned")
        self.occupancy_series = self.batch_occupancy.series()
        self.lock_wait_series = self.lock_wait.series()
        for fmt in ("json", "binary"):
            for front in ("threaded", "aio"):
                self.wire_encode.series(format=fmt, transport=front)
                self.wire_decode.series(format=fmt, transport=front)
        # same schema-stability discipline for the viewport families:
        # both delta kinds render (at 0) from the first scrape
        self.delta_frames.inc(0.0, kind="key")
        self.delta_frames.inc(0.0, kind="delta")
        self.shard_fetch_series = self.shard_fetch.series()

    # -- trace delegates -------------------------------------------------

    def span(self, name: str, **fields):
        return self.tracer.span(name, **fields)

    def event(self, name: str, dur_s: float = 0.0, t0=None, **fields):
        self.tracer.event(name, dur_s, t0, **fields)

    # -- telemetry history + SLO engine ------------------------------------

    def arm_telemetry(self, interval_s: float = 5.0, manager=None,
                      objectives=None, damp_evals: int = 3,
                      clock=None, start: bool = True):
        """Construct the sampler + SLO engine (one sample every
        ``interval_s``).  Idempotent; ``start=False`` (tests)
        skips the daemon thread so ``sample_once``/``evaluate`` can be
        driven by hand against an injected ``clock``."""
        if self.telemetry is not None:
            return self.telemetry
        from mpi_tpu_torch.obs.slo import SloEngine, default_objectives
        from mpi_tpu_torch.obs.timeseries import TelemetryRecorder

        kw = {} if clock is None else {"clock": clock}
        tel = TelemetryRecorder(self.metrics, interval_s=interval_s, **kw)
        slo = SloEngine(objectives or default_objectives(), tel,
                        manager=manager, obs=self,
                        damp_evals=damp_evals, **kw)
        tel.after_sample = slo.evaluate
        tel.bind_metrics(self.metrics)
        slo.bind_metrics(self.metrics)
        self.telemetry = tel
        self.slo = slo
        if start:
            tel.start()
        return tel

    # -- flight recorder + anomaly profiling ------------------------------

    def arm_flight(self, capacity: int = 1024, manager=None,
                   anomaly: bool = False,
                   profile_dir: Optional[str] = None,
                   devmem: bool = True, halo_probe: bool = True,
                   clock=None, **anomaly_kw):
        """Construct the per-dispatch flight recorder (plus the drift
        detector with ``anomaly`` and, when telemetry is already armed,
        the device-memory sampler).  Idempotent.  Call AFTER
        ``arm_telemetry`` — the devmem sample and the anomaly
        evaluation chain onto the telemetry ticker; without telemetry,
        tests drive ``anomaly.evaluate`` by hand."""
        if self.flight is not None:
            return self.flight
        from mpi_tpu_torch.obs.flight import FlightRecorder

        fl = FlightRecorder(capacity=capacity, obs=self)
        fl.bind_metrics(self.metrics)
        self.flight = fl
        kw = {} if clock is None else {"clock": clock}
        if anomaly:
            from mpi_tpu_torch.obs.anomaly import AnomalyDetector

            an = AnomalyDetector(self, profile_dir=profile_dir,
                                 **kw, **anomaly_kw)
            an.bind_metrics(self.metrics)
            self.anomaly = an
            fl.on_record = an.observe
        tel = self.telemetry
        if tel is not None:
            if devmem:
                from mpi_tpu_torch.obs.devmem import DevMemSampler

                dm = DevMemSampler(self, manager=manager,
                                   halo_probe=halo_probe, **kw)
                dm.bind_metrics(self.metrics)
                self.devmem = dm
                tel.add_series("device_memory_bytes", "gauge",
                               dm.memory_total)
                if manager is not None:
                    tel.add_series(
                        "engine_cache_entries", "gauge",
                        lambda: (lambda st: st["size"]
                                 + st["batched"]["size"])(
                                     manager.cache.stats()))
            prev = tel.after_sample
            dm_, an_ = self.devmem, self.anomaly

            def _chain(now):
                if prev is not None:
                    prev(now)
                if dm_ is not None:
                    dm_.sample(now)
                if an_ is not None:
                    an_.evaluate(now)

            tel.after_sample = _chain
        return fl

    # -- manager binding -------------------------------------------------

    def bind_manager(self, manager) -> None:
        """Register scrape-time callbacks over the manager's live state.
        Idempotent (re-binding replaces the callbacks); values are READ
        at scrape time from their authoritative owners, never shadowed."""
        from mpi_tpu_torch.obs.profile import _live_engines

        m = self.metrics
        cache = manager.cache

        m.gauge_fn("mpi_tpu_sessions", "Live sessions", lambda: len(manager))
        m.gauge_fn(
            "mpi_tpu_degraded_sessions",
            "Sessions currently served by the serial_np fallback",
            lambda: sum(1 for s in manager._session_list() if s.degraded))
        m.counter_fn(
            "mpi_tpu_degraded_sessions_total",
            "Sessions ever degraded to the serial_np fallback",
            lambda: manager.degraded_total)
        m.counter_fn(
            "mpi_tpu_engine_failures_total",
            "Engine dispatch failures (manager's authoritative count)",
            lambda: manager.engine_failures)
        m.counter_fn(
            "mpi_tpu_watchdog_timeouts_total",
            "Dispatches abandoned to the watchdog",
            lambda: manager.watchdog_timeouts)

        def _breaker_states():
            br = cache.breaker_stats()
            return [({"state": "open"}, len(br["open"])),
                    ({"state": "half_open"}, len(br["half_open"]))]

        m.gauge_fn("mpi_tpu_breaker_signatures",
                   "Plan signatures per breaker state", _breaker_states)
        m.counter_fn("mpi_tpu_breaker_trips_total",
                     "Times any signature's breaker opened",
                     lambda: cache.breaker_stats()["trips"])

        def _cache_events():
            st = cache.stats()
            return [({"cache": "engine", "event": k}, st[k])
                    for k in ("hits", "misses", "evictions")] + \
                   [({"cache": "batched", "event": k}, st["batched"][k])
                    for k in ("hits", "misses", "evictions")]

        m.counter_fn("mpi_tpu_cache_events_total",
                     "Engine/batched-stepper cache hits, misses, evictions",
                     _cache_events)
        m.gauge_fn("mpi_tpu_cache_size", "Cached compiled engines",
                   lambda: len(cache))

        def _engine_counters():
            engines = _live_engines(manager)
            return [
                ({"kind": "compiles"},
                 sum(e.compile_count for e in engines)),
                ({"kind": "batched_compiles"},
                 sum(e.batched_compile_count for e in engines)),
                ({"kind": "step_calls"},
                 sum(e.step_calls for e in engines)),
                ({"kind": "batched_step_calls"},
                 sum(e.batched_step_calls for e in engines)),
            ]

        m.counter_fn("mpi_tpu_engine_counters_total",
                     "Engine compile and dispatch counters (all engines)",
                     _engine_counters)
        m.gauge_fn("mpi_tpu_engine_compile_wall_seconds_total",
                   "Accumulated XLA compile wall across engines",
                   lambda: sum(getattr(e, "compile_wall_s", 0.0)
                               for e in _live_engines(manager)))

        if manager.batcher is not None:
            m.gauge_fn("mpi_tpu_batch_queue_depth",
                       "Step requests waiting in coalescing queues",
                       manager.batcher.queue_depth)

        dispatcher = getattr(manager, "dispatcher", None)
        if dispatcher is not None:
            # scrape-time callbacks over the dispatcher's authoritative
            # queue state — same no-shadow-counting rule as everything
            # else here; values match /stats' "async" section exactly
            m.gauge_fn("mpi_tpu_ticket_queue_depth",
                       "Async tickets waiting for the dispatch loop",
                       dispatcher.queue_depth)
            m.gauge_fn("mpi_tpu_tickets_pending",
                       "Async tickets enqueued but not yet resolved",
                       dispatcher.pending)
            m.counter_fn("mpi_tpu_tickets_completed_total",
                         "Async tickets resolved (done or error)",
                         lambda: dispatcher.tickets_completed)
            m.counter_fn("mpi_tpu_unit_rounds_total",
                         "Depth-1 device rounds executed by the dispatch "
                         "loop (chained, one sync per chain)",
                         lambda: dispatcher.unit_rounds)

        def _cells_per_sec():
            out = []
            for s in manager._session_list():
                tp = s.throughput()
                if tp["cell_updates_per_s"]:
                    out.append(({"session": s.id}, tp["cell_updates_per_s"]))
            return out

        m.gauge_fn("mpi_tpu_session_cells_per_second",
                   "Per-session steady-state cell updates per second",
                   _cells_per_sec)

        def _sparse_series(field):
            # scrape-time readout of each sparse session's dirty map; a
            # concurrent step may have donated the grid buffer out from
            # under us (Array deleted) — skip that session this scrape
            out = []
            for s in manager._session_list():
                eng = s.engine
                if eng is None or getattr(eng, "sparse_plan", None) is None:
                    continue
                try:
                    sa = eng.sparse_stats(s.grid)
                except Exception:
                    continue
                out.append(({"session": s.id}, sa[field]))
            return out

        m.gauge_fn("mpi_tpu_active_tiles",
                   "Dirty tiles the next sparse step must compute",
                   lambda: _sparse_series("active_tiles"))
        m.gauge_fn("mpi_tpu_active_fraction",
                   "Active fraction of the sparse tile map (0-1)",
                   lambda: _sparse_series("active_fraction"))
        m.counter_fn("mpi_tpu_trace_spans_total",
                     "Spans/events recorded by the tracer",
                     lambda: self.tracer.stats()["recorded"])

        # -- usage ledger: per-SIGNATURE series only — the
        # per-session rows stay on /usage so scrape cardinality is
        # bounded by distinct plans, never by tenant count
        ledger = self.ledger

        m.counter_fn("mpi_tpu_usage_device_seconds_total",
                     "Committed device sync wall per plan signature",
                     lambda: ledger.signature_series("device_s"))
        m.counter_fn("mpi_tpu_usage_syncs_total",
                     "Committed dispatches (device syncs) per plan "
                     "signature",
                     lambda: ledger.signature_series("syncs"))
        m.counter_fn("mpi_tpu_usage_generations_total",
                     "Generations advanced per plan signature",
                     lambda: ledger.signature_series("generations"))
        m.counter_fn("mpi_tpu_usage_cells_total",
                     "Cell-updates served per plan signature",
                     lambda: ledger.signature_series("cells"))
        m.counter_fn("mpi_tpu_usage_flops_total",
                     "Cost-card-derived FLOPs served per plan signature",
                     lambda: ledger.signature_series("flops"))

        def _cost_card_counts():
            counts = {"kernel_count": 0}
            for e in _live_engines(manager):
                for c in e.cost_cards():
                    counts[c.source] = counts.get(c.source, 0) + 1
            return [({"source": k}, v) for k, v in counts.items()]

        m.gauge_fn("mpi_tpu_cost_cards",
                   "Captured executable cost cards by capture source",
                   _cost_card_counts)

        def _tuned_plans():
            counts = {"tuned": 0, "default": 0}
            for e in _live_engines(manager):
                k = "tuned" if getattr(e, "tuned_plan", None) else "default"
                counts[k] += 1
            return [({"plan": k}, v) for k, v in counts.items()]

        m.gauge_fn("mpi_tpu_tuned_plans",
                   "Live engines by plan provenance (tune-cache winner "
                   "applied vs default build)",
                   _tuned_plans)

        def _roofline_efficiency():
            # achieved cells/s (ledger) over the cost-model bound (the
            # captured cards' trip-count-safe ops/cell into the roof),
            # per live signature — computed at scrape time
            from mpi_tpu_torch.obs.cost import (
                ops_per_cell_estimate, roof_ops_per_s,
            )

            roof = roof_ops_per_s()
            rows = ledger.signature_rows()
            out = []
            seen = set()
            for e in _live_engines(manager):
                label = getattr(e, "sig_label", None)
                if label is None or label in seen:
                    continue
                seen.add(label)
                row = rows.get(label)
                if not row or row["device_s"] <= 0:
                    continue
                opc = ops_per_cell_estimate(e.cost_cards(), e.config.cells)
                if opc is None:
                    continue
                bound = roof / opc
                out.append(({"sig": label},
                            (row["cells"] / row["device_s"]) / bound))
            return out

        m.gauge_fn("mpi_tpu_roofline_efficiency",
                   "Achieved cells/s over the cost-model roofline bound, "
                   "per plan signature",
                   _roofline_efficiency)

        # -- durable state plane: scrape-time readouts of the
        # StateStore's authoritative counters and state machine.  The
        # families are always present — a manager without a state dir
        # scrapes zeros/closed rather than dropping them, so dashboards
        # and the required-family gate see one stable schema.
        store = getattr(manager, "store", None)
        m.counter_fn(
            "mpi_tpu_checkpoint_bytes_total",
            "Durable bytes written, by form (full record envelopes "
            "vs appended journal entries)",
            lambda: [({"kind": "full"}, store.bytes_full if store else 0),
                     ({"kind": "delta"},
                      store.bytes_delta if store else 0)])
        m.counter_fn(
            "mpi_tpu_state_records_corrupt_total",
            "Persisted records quarantined for failing CRC/envelope "
            "validation at restore or adoption",
            lambda: store.corrupt_records if store else 0)
        m.gauge_fn(
            "mpi_tpu_persistence_state",
            "Persistence state machine: 0 closed (healthy), "
            "1 recovering (flushing backlog), 2 degraded",
            lambda: ({"closed": 0, "recovering": 1, "degraded": 2}
                     [store.persistence_state()["state"]] if store else 0))
        m.counter_fn(
            "mpi_tpu_journal_compactions_total",
            "Session journals compacted into a full record write",
            lambda: store.compactions if store else 0)

    # -- export ----------------------------------------------------------

    def render_metrics(self, openmetrics: bool = False) -> str:
        return self.metrics.render(openmetrics=openmetrics)

    def stats(self) -> dict:
        out = {"trace": self.tracer.stats()}
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.stats()
        if self.flight is not None:
            out["flight"] = self.flight.stats()
        if self.anomaly is not None:
            out["anomaly"] = self.anomaly.stats()
        if self.devmem is not None:
            out["devmem"] = self.devmem.stats()
        return out

    def close(self) -> None:
        if self.telemetry is not None:
            self.telemetry.stop()
        self.tracer.close()
