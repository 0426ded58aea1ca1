"""``mpi_tpu_torch serve`` — run the session service on one GPU.

Example::

    python -m mpi_tpu_torch.cli serve --port 8000 --cache-size 8
    curl -X POST localhost:8000/sessions -d '{"rows":4096,"cols":4096}'
    curl -X POST localhost:8000/sessions/s1/step -d '{"steps":10}'
    curl localhost:8000/sessions/s1/density
    curl localhost:8000/stats

Fault tolerance (see README "Fault tolerance" for the full story)::

    python -m mpi_tpu_torch.cli serve --state-dir /var/lib/mpi_tpu \\
        --request-timeout-s 30 --breaker-threshold 3

``--state-dir`` makes sessions survive a ``kill -9`` (crash-safe JSON
records + deterministic replay); ``--request-timeout-s`` bounds every
verb; the breaker flags govern when a failing engine's plan is
quarantined and its sessions degrade to the ``serial_np`` oracle.
``--inject-faults`` (or the ``MPI_TPU_FAULTS`` env var) drives the
recovery paths deterministically for testing.

The flags and their help are the reference's (``mpi_tpu/serve/cli.py``),
with ``--device {cuda,cpu}`` in place of its platform override: sessions
step on the card (K1-K3) unless ``--device cpu`` asks for the kernels'
plain versions, and a box without CUDA refuses to serve rather than fall
back.  ``--tune-cache PATH|auto`` applies the tuner's cached winners
(``mpi_tpu_torch/tune``) on every engine build miss.

Cluster mode (``--peers`` / ``--peers-file``) is the reference's: N
processes, each on the card, serve as one logical service over a shared
``--state-dir``::

    python -m mpi_tpu_torch.cli serve --port 8001 --state-dir D \
        --peers 127.0.0.1:8002,127.0.0.1:8003
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="mpi_tpu_torch serve",
        description="persistent multi-session engine service on one GPU "
        "(HTTP + JSON, engine cache)",
    )
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds an ephemeral port (printed on startup)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default) steps sessions on the GPU "
                   "through the hand-written kernels; cpu runs the "
                   "kernels' plain PyTorch versions instead")
    p.add_argument("--cache-size", type=int, default=8,
                   help="max cached built engines (LRU beyond this)")
    p.add_argument("--batch-window-ms", type=float, default=2.0,
                   help="coalescing window for same-signature concurrent "
                   "steps: the first arrival waits this long collecting "
                   "peers before dispatching one stacked batched step "
                   "(0 disables the wait but still coalesces whatever is "
                   "already queued)")
    p.add_argument("--batch-max", type=int, default=8,
                   help="max boards per stacked batched dispatch")
    p.add_argument("--no-batch", action="store_true",
                   help="disable microbatching; every step dispatches solo")
    p.add_argument("--no-async", action="store_true",
                   help="disable ticketed async stepping: POST /step with "
                   "async=1 answers 400 and no dispatch loop runs (async "
                   "is opt-in per request either way; the sync path is "
                   "identical with or without this flag)")
    p.add_argument("--async-queue-max", type=int, default=1024,
                   help="bound on tickets queued for the async dispatch "
                   "loop; an enqueue beyond it answers a structured 503 "
                   "(backpressure, not an error)")
    p.add_argument("--ticket-ttl-s", type=float, default=600.0,
                   help="seconds a RESOLVED async ticket stays "
                   "resolvable via GET /result/<ticket> before aging "
                   "out (0 keeps tickets until the 4096-entry size cap "
                   "evicts them; pending tickets never expire this way)")
    p.add_argument("--verbose", action="store_true",
                   help="log one line per HTTP request (with request ids)")
    p.add_argument("--state-dir", default=None,
                   help="persist session records here (crash-safe JSON); "
                   "restart with the same dir to restore every board by "
                   "deterministic replay, bit-identical")
    p.add_argument("--checkpoint-every", type=int, default=64,
                   help="generations between packed grid snapshots in the "
                   "session record (bounds replay length on restore)")
    p.add_argument("--state-degrade",
                   choices=("continue", "readonly", "shed"),
                   default="continue",
                   help="policy while persistence is degraded (the state "
                   "dir stopped taking writes): 'continue' keeps serving "
                   "and re-checkpoints when the disk heals, 'readonly' "
                   "refuses mutating verbs with 503+Retry-After, 'shed' "
                   "refuses all session verbs so a balancer drains the "
                   "node")
    p.add_argument("--no-state-journal", action="store_true",
                   help="disable the per-session append-only journal and "
                   "rewrite the full record every committed step (the "
                   "pre-v2 behavior; costs full-record bytes per step)")
    p.add_argument("--journal-max-bytes", type=int, default=1 << 20,
                   help="journal size that triggers compaction into a "
                   "full record write (default 1 MiB)")
    p.add_argument("--journal-max-age-s", type=float, default=300.0,
                   help="journal age that triggers compaction (bounds "
                   "replay work after a crash; default 300)")
    p.add_argument("--state-keep", type=int, default=2,
                   help="last-good ancestor records kept per session "
                   "(<sid>.json.1..N; restore falls back down this chain "
                   "when the head is corrupt; default 2)")
    p.add_argument("--request-timeout-s", type=float, default=30.0,
                   help="time budget per request; a hung dispatch becomes "
                   "a structured 503 with the session intact "
                   "(0 disables; per-request override: ?timeout_s=)")
    p.add_argument("--step-retries", type=int, default=2,
                   help="retries (with exponential backoff) for a failed "
                   "engine step before answering 503")
    p.add_argument("--retry-backoff-ms", type=float, default=50.0,
                   help="initial retry backoff, doubling per attempt")
    p.add_argument("--breaker-threshold", type=int, default=3,
                   help="consecutive engine failures that open a plan "
                   "signature's circuit breaker")
    p.add_argument("--breaker-cooldown-s", type=float, default=30.0,
                   help="open-breaker cooldown before one half-open trial "
                   "dispatch is admitted")
    p.add_argument("--no-degrade", action="store_true",
                   help="do NOT fall back to the serial_np oracle when a "
                   "breaker opens; affected requests answer 503 instead")
    p.add_argument("--inject-faults", default=None, metavar="SPEC",
                   help="deterministic fault plan at the engine dispatch "
                   "boundary, e.g. 'step:3:raise' or 'any:2:hang:5' "
                   "(testing; env fallback MPI_TPU_FAULTS)")
    p.add_argument("--tune-cache", default=None, metavar="PATH",
                   help="apply autotuned plan winners from this tune "
                   "cache on every engine build miss (written by 'python "
                   "-m mpi_tpu_torch.tune'); 'auto' resolves to "
                   "<state-dir>/tune_cache.json when --state-dir is set, "
                   "else the default perf/tune_cache_torch.json.  Unset: "
                   "no cache is read, plans build exactly as requested")
    p.add_argument("--no-obs", action="store_true",
                   help="disable tracing/metrics entirely: /metrics answers "
                   "404 and the step path runs uninstrumented "
                   "(bit-identical results either way)")
    p.add_argument("--trace-log", default=None, metavar="PATH",
                   help="stream every trace span as a JSONL line to PATH "
                   "(the ring buffer alone otherwise; dumped on any 500)")
    p.add_argument("--trace-capacity", type=int, default=4096,
                   help="span ring-buffer size (oldest spans overwritten)")
    p.add_argument("--telemetry-interval-s", type=float, default=None,
                   metavar="SECS",
                   help="arm the in-process telemetry recorder + SLO "
                   "engine: sample selected metrics series and evaluate "
                   "burn rates every SECS seconds, serving GET /slo and "
                   "GET /debug/timeseries.  Unset (the default): no "
                   "sampler runs and the scrape/trace output is "
                   "byte-identical to pre-telemetry builds")
    p.add_argument("--slo-file", default=None, metavar="PATH",
                   help="JSON objectives for the SLO engine (see README "
                   "'SLOs and telemetry history' for the schema); implies "
                   "--telemetry-interval-s 5 when that flag is unset.  "
                   "Unset: built-in defaults (availability 99.9%%, "
                   "dispatch p99 < 1s, freshness 600s)")
    p.add_argument("--admission", action="store_true",
                   help="arm multi-tenant admission control with the "
                   "built-in unlimited default tenant: requests carry "
                   "X-Gol-Tenant/X-Gol-Class headers, quotas gate in "
                   "ledger currency, the async dispatcher schedules by "
                   "priority class, and a critical SLO sheds low classes "
                   "first.  Unset (and no --tenants-file): no admission "
                   "layer runs and ids/payloads/scrape text are "
                   "byte-identical to pre-admission builds")
    p.add_argument("--tenants-file", default=None, metavar="PATH",
                   help="JSON tenant registry (see README 'Admission "
                   "control and multi-tenancy' for the schema); implies "
                   "--admission.  Unset with --admission: one unlimited "
                   "default tenant")
    p.add_argument("--flight-recorder", action="store_true",
                   help="arm the per-dispatch flight recorder: every "
                   "committed dispatch leaves a bounded ring record "
                   "(plan signature, engine kind, k-segment composition, "
                   "batch riders, sparse rung, donation, timing split) "
                   "served at GET /debug/flights and folded into crash "
                   "dumps.  Unset: no ring exists and the scrape/trace "
                   "output is byte-identical to pre-flight builds")
    p.add_argument("--flight-capacity", type=int, default=1024,
                   help="flight-record ring size (oldest records "
                   "overwritten; one flight_drop trace event per full "
                   "ring turn)")
    p.add_argument("--anomaly-detect", action="store_true",
                   help="arm per-signature dispatch-latency drift "
                   "detection on the telemetry cadence (implies "
                   "--flight-recorder, and --telemetry-interval-s 5 when "
                   "that flag is unset): sustained 1m+5m median drift vs "
                   "the 1h baseline emits a dispatch_anomaly trace "
                   "event, serves GET /debug/anomalies, and — with "
                   "--profile-dir — arms one bounded, cooldown-gated "
                   "torch.profiler capture per episode")
    p.add_argument("--anomaly-cooldown-s", type=float, default=600.0,
                   help="minimum seconds between anomaly-armed profiler "
                   "captures (never back-to-back)")
    p.add_argument("--anomaly-retention", type=int, default=4,
                   help="keep at most this many anomaly-* capture dirs "
                   "under --profile-dir (oldest pruned first)")
    p.add_argument("--profile-dir", default=None, metavar="DIR",
                   help="arm POST /debug/profile?secs=N: captures a "
                   "torch.profiler device trace into DIR (off when unset); "
                   "also where --anomaly-detect rotates its captures")
    p.add_argument("--front", choices=("threaded", "aio"),
                   default="threaded",
                   help="HTTP front end: 'threaded' (stdlib thread-per-"
                   "connection, the default — byte-compatible JSON) or "
                   "'aio' (selectors event loop: idle ticket waiters park "
                   "as sockets, GET /stream/<sid> pushes binary frames)")
    p.add_argument("--http-max-body", type=int, default=64 << 20,
                   metavar="BYTES",
                   help="reject request bodies larger than this with a "
                   "structured 413 before reading (default 64 MiB)")
    p.add_argument("--aio-workers", type=int, default=4,
                   help="worker threads the aio front uses for blocking "
                   "session verbs (the event loop itself never blocks)")
    p.add_argument("--stream-buffer-kib", type=int, default=256,
                   help="per-socket write-buffer bound for /stream "
                   "consumers; a slower consumer gets drop-to-latest "
                   "frames instead of an unbounded queue")
    p.add_argument("--peers", default=None, metavar="HOST:PORT,...",
                   help="comma-separated peer serving addresses; setting "
                   "this (or --peers-file) turns on cluster mode: sticky "
                   "session routing, gossip, and cluster roll-ups on "
                   "/usage and /healthz.  Unset: single-process serving, "
                   "bit-identical to pre-cluster builds")
    p.add_argument("--peers-file", default=None, metavar="PATH",
                   help="seed-peer file, one host:port per line "
                   "('#' comments allowed); merged with --peers")
    p.add_argument("--advertise", default=None, metavar="HOST:PORT",
                   help="the address peers reach THIS process at (the "
                   "node id); defaults to the bound host:port, which is "
                   "only right when peers share the host")
    p.add_argument("--gossip-interval-s", type=float, default=1.0,
                   help="seconds between gossip rounds; peer-down and "
                   "breaker-quarantine TTL default to 3x this")
    p.add_argument("--peer-timeout-s", type=float, default=5.0,
                   help="socket timeout for proxied requests and gossip "
                   "sends to a peer")
    p.add_argument("--peer-down-s", type=float, default=None,
                   help="heartbeat silence before a peer is reported "
                   "down/suspect (default 3x the gossip interval)")
    p.add_argument("--peer-dead-s", type=float, default=None,
                   help="heartbeat silence before a peer is CONFIRMED "
                   "dead: removed from the ring, its sessions adopted "
                   "from the shared --state-dir (default 3x --peer-down-s)")
    p.add_argument("--proxy-retries", type=int, default=2,
                   help="retries (doubling backoff) for an unreachable "
                   "peer on idempotent proxied verbs (GET); "
                   "non-idempotent verbs always fail fast")
    p.add_argument("--proxy-backoff-ms", type=float, default=50.0,
                   help="initial proxy retry backoff, doubling per attempt")
    p.add_argument("--proxy-timeout-s", type=float, default=None,
                   help="socket timeout per proxy hop attempt "
                   "(default: --peer-timeout-s)")
    return p


def tune_cache_path(args) -> Optional[str]:
    """The tune cache ``--tune-cache`` names: ``auto`` is
    ``<state-dir>/tune_cache.json`` with ``--state-dir``, else
    ``tune.default_cache_path()``; None without the flag."""
    if args.tune_cache != "auto":
        return args.tune_cache
    if args.state_dir:
        return os.path.join(args.state_dir, "tune_cache.json")
    from mpi_tpu_torch.tune import default_cache_path

    return default_cache_path()


def serve_main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    from mpi_tpu_torch.backends.cuda import resolve_device
    from mpi_tpu_torch.config import ConfigError
    from mpi_tpu_torch.serve.cache import EngineCache
    from mpi_tpu_torch.serve.httpd import make_server
    from mpi_tpu_torch.serve.session import SessionManager

    try:
        resolve_device(args.device)     # no CUDA: refuse, never the CPU
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    faults = args.inject_faults or os.environ.get("MPI_TPU_FAULTS") or None
    cluster_mode = (args.peers is not None or args.peers_file is not None)
    obs = None
    if not args.no_obs:
        from mpi_tpu_torch.obs import Obs

        obs = Obs(trace_capacity=args.trace_capacity,
                  trace_log=args.trace_log)
    tune_cache = tune_cache_path(args)
    try:
        manager = SessionManager(
            EngineCache(max_size=args.cache_size,
                        breaker_threshold=args.breaker_threshold,
                        breaker_cooldown_s=args.breaker_cooldown_s),
            batching=not args.no_batch,
            batch_window_ms=args.batch_window_ms,
            batch_max=args.batch_max,
            async_enabled=not args.no_async,
            async_queue_max=args.async_queue_max,
            ticket_ttl_s=args.ticket_ttl_s,
            state_dir=args.state_dir,
            checkpoint_every=args.checkpoint_every,
            state_degrade=args.state_degrade,
            state_journal=not args.no_state_journal,
            journal_max_bytes=args.journal_max_bytes,
            journal_max_age_s=args.journal_max_age_s,
            state_keep=args.state_keep,
            request_timeout_s=args.request_timeout_s,
            step_retries=args.step_retries,
            retry_backoff_s=args.retry_backoff_ms / 1e3,
            degrade=not args.no_degrade,
            faults=faults,
            obs=obs,
            tune_cache=tune_cache,
            device=args.device,
            # cluster mode shares --state-dir across nodes: restore is
            # deferred to attach_cluster, which takes only owned records
            defer_restore=cluster_mode and args.state_dir is not None,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    flight_on = args.flight_recorder or args.anomaly_detect
    if flight_on and obs is None:
        print("error: --flight-recorder/--anomaly-detect need "
              "observability (drop --no-obs)", file=sys.stderr)
        return 2
    telemetry_s = args.telemetry_interval_s
    if telemetry_s is None and (args.slo_file or args.anomaly_detect):
        # --slo-file implies arming; --anomaly-detect too — drift
        # evaluation rides the sampler cadence
        telemetry_s = 5.0
    if telemetry_s is not None and obs is None:
        print("error: --telemetry-interval-s/--slo-file need "
              "observability (drop --no-obs)", file=sys.stderr)
        return 2
    if telemetry_s is not None:
        from mpi_tpu_torch.obs.slo import load_slo_file

        objectives = None
        if args.slo_file:
            try:
                objectives, slo_opts = load_slo_file(args.slo_file)
            except ConfigError as e:
                print(f"error: --slo-file: {e}", file=sys.stderr)
                return 2
        else:
            slo_opts = {}
        obs.arm_telemetry(interval_s=telemetry_s, manager=manager,
                          objectives=objectives, **slo_opts)
    if flight_on:
        # after arm_telemetry: the devmem sampler and the drift
        # evaluation chain onto the ticker, which must exist first
        anomaly_kw = {}
        if args.anomaly_detect:
            anomaly_kw = {"cooldown_s": args.anomaly_cooldown_s,
                          "retention": args.anomaly_retention}
        obs.arm_flight(capacity=args.flight_capacity, manager=manager,
                       anomaly=args.anomaly_detect,
                       profile_dir=args.profile_dir, **anomaly_kw)
    admission_on = args.admission or bool(args.tenants_file)
    if admission_on and obs is None:
        print("error: --admission/--tenants-file need "
              "observability (drop --no-obs)", file=sys.stderr)
        return 2
    if admission_on:
        # after arm_telemetry: the shedder subscribes to the live SLO
        # engine, which only exists once telemetry is armed
        from mpi_tpu_torch.admission import AdmissionControl
        from mpi_tpu_torch.admission.tenants import load_tenants_file

        tenants = None
        if args.tenants_file:
            try:
                tenants = load_tenants_file(args.tenants_file)
            except ConfigError as e:
                print(f"error: --tenants-file: {e}", file=sys.stderr)
                return 2
        AdmissionControl(tenants).arm(manager, obs)
    if args.front == "aio":
        from mpi_tpu_torch.serve.aio import make_aio_server

        server = make_aio_server(
            args.host, args.port, manager, verbose=args.verbose,
            profile_dir=args.profile_dir, max_body=args.http_max_body,
            workers=args.aio_workers,
            stream_buffer=args.stream_buffer_kib << 10)
    else:
        server = make_server(args.host, args.port, manager,
                             verbose=args.verbose,
                             profile_dir=args.profile_dir,
                             max_body=args.http_max_body)
    host, port = server.server_address[:2]
    node = None
    if cluster_mode:
        import socket

        from mpi_tpu_torch.cluster import ClusterNode

        peers: List[str] = []
        if args.peers:
            peers += [a.strip() for a in args.peers.split(",") if a.strip()]
        if args.peers_file:
            try:
                with open(args.peers_file) as f:
                    for line in f:
                        line = line.split("#", 1)[0].strip()
                        if line:
                            peers.append(line)
            except OSError as e:
                print(f"error: --peers-file: {e}", file=sys.stderr)
                server.server_close()
                return 2
        advertise = args.advertise or f"{host}:{port}"
        try:
            node = ClusterNode(advertise, peers, manager,
                               interval_s=args.gossip_interval_s,
                               timeout_s=args.peer_timeout_s,
                               down_after_s=args.peer_down_s,
                               dead_after_s=args.peer_dead_s,
                               proxy_retries=args.proxy_retries,
                               proxy_backoff_s=args.proxy_backoff_ms / 1e3,
                               proxy_timeout_s=args.proxy_timeout_s,
                               state_dir=args.state_dir, obs=obs)
        except ValueError as e:        # ConfigError included
            print(f"error: {e}", file=sys.stderr)
            server.server_close()
            return 2
        manager.attach_cluster(node)
        server.core.cluster = node
        if obs is not None:
            # cluster scrapes are federated: every sample carries the
            # process identity (single-process mode never sets these)
            obs.metrics.set_const_labels(
                {"host": socket.gethostname(), "process": advertise})
        node.start()
    batch = ("off" if args.no_batch else
             f"window {args.batch_window_ms}ms max {args.batch_max}")
    extras = []
    if args.no_async:
        extras.append("async off")
    if args.state_dir:
        extras.append(f"state-dir {args.state_dir}")
        if manager.restored_sessions:
            extras.append(f"restored {manager.restored_sessions}")
    if faults:
        extras.append(f"faults '{faults}'")
    if tune_cache:
        extras.append(f"tune-cache {tune_cache}")
    if args.no_obs:
        extras.append("obs off")
    elif args.trace_log:
        extras.append(f"trace-log {args.trace_log}")
    if telemetry_s is not None:
        extras.append(f"telemetry {telemetry_s}s"
                      + (f" slo-file {args.slo_file}"
                         if args.slo_file else ""))
    if admission_on:
        extras.append("admission"
                      + (f" tenants-file {args.tenants_file}"
                         if args.tenants_file else " (default tenant)"))
    if flight_on:
        extras.append(f"flight {args.flight_capacity}"
                      + (" anomaly" if args.anomaly_detect else ""))
    if args.profile_dir:
        extras.append(f"profile-dir {args.profile_dir}")
    if args.device != "cuda":
        extras.append(f"device {args.device}")
    if args.front != "threaded":
        extras.append(f"front {args.front} ({args.aio_workers} workers)")
    if node is not None:
        extras.append(f"cluster {node.id} tag {node.tag} "
                      f"peers {len(node.peers)}")
    extra = (", " + ", ".join(extras)) if extras else ""
    print(f"[mpi_tpu] serving on http://{host}:{port} "
          f"(cache size {args.cache_size}, batch {batch}{extra})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("[mpi_tpu] shutting down", flush=True)
    finally:
        if node is not None:
            node.stop()
        server.server_close()
        if obs is not None:
            obs.close()                 # flush + fsync the trace log
    return 0


if __name__ == "__main__":
    sys.exit(serve_main())
