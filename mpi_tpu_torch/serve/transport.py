"""Front-end-agnostic HTTP application core for the serve stack.

The request *semantics* — routing, validation, session-manager verbs,
error→status mapping, observability, wire-format negotiation — live here
in :class:`AppCore`, while the *transports* own sockets and bytes: the
threaded stdlib front (``serve/httpd.py``, the default) and the
selectors-based non-blocking front (``serve/aio.py``) both feed
:meth:`AppCore.dispatch` a :class:`Request` and write back the
:class:`Response` it returns.  One core, N fronts — the two can never
drift on a route or an error shape.  Routes, status codes, structured
errors, JSON shapes and binary frames are the reference's
(``mpi_tpu/serve/transport.py``), byte for byte.

Wire-format negotiation (the binary protocol rides here so every front
gets it for free):

* ``GET /sessions/<id>/snapshot`` — ``Accept: application/x-gol-grid``
  answers one binary frame (``serve/wire.py``); anything else answers
  the JSON shape.  Both come from the same
  ``SessionManager.snapshot_array`` fetch, so the formats cannot
  disagree about the grid.
* ``PUT /sessions/<id>/board`` — board write.  ``Content-Type:
  application/x-gol-grid`` sends a binary frame (its header's
  generation field, when flagged, rebases the session's generation);
  JSON sends ``{"grid": ['0101', ...], "generation": optional}``.
* ``GET /result/<ticket>`` — with binary ``Accept``: a *done* ticket
  answers a frame of the session's current grid; pending/error answer
  the usual JSON (status codes carry the semantics either way).
* ``GET /stream/<sid>?every=k`` — returns a :class:`StreamPlan`; only
  the aio front can park a socket and push frames, so the core answers
  a structured 501 on any other transport.

Request bodies are bounded (``--http-max-body``): a ``Content-Length``
over the bound answers a structured 413 *before any body byte is read*,
and the connection is closed (the unread body makes keep-alive framing
unrecoverable).

In cluster mode (``AppCore.cluster``, set by the serve CLI after the
socket binds) the core routes as the reference's does: sticky session
placement, one proxy hop to the owner, ``/cluster/*`` and the trace
fan-out to peers.  With ``cluster`` None every request is served by this
process, byte for byte as without the cluster package.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import sys
import tempfile
import time
import traceback
from typing import Callable, List, Optional, Tuple
from urllib.parse import parse_qs, urlsplit

from mpi_tpu_torch.admission.quota import AdmissionReject, retry_after_header
from mpi_tpu_torch.cluster.proxy import (
    FORWARDED_HEADER, SESSION_ID_HEADER, PeerUnreachable, proxy_request,
)
from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.obs.trace import reset_request_id, set_request_id
from mpi_tpu_torch.obs.tracectx import (
    TRACEPARENT_HEADER, current_trace_context, format_traceparent, mint,
    parse_traceparent, reset_trace_context, set_trace_context, stitch_spans,
)
from mpi_tpu_torch.serve import wire
from mpi_tpu_torch.serve.recovery import StorageDegradedError
from mpi_tpu_torch.serve.session import (
    DeadlineError, EngineStepError, EngineUnavailableError, SessionManager,
    format_grid_rows, parse_grid_rows,
)
from mpi_tpu_torch.serve.ticket import TicketQueueFullError

DEFAULT_MAX_BODY = 64 << 20             # 64 MiB

# a scraper negotiates exemplar-capable output by naming this media type
# in Accept; everything else gets the byte-identical Prometheus text
OPENMETRICS_MEDIA_TYPE = "application/openmetrics-text"

# admission control: the request's tenant and an optional
# priority-class override.  Only read when admission is armed; unarmed
# servers never look at either, so their behavior is byte-identical.
TENANT_HEADER = "X-Gol-Tenant"
CLASS_HEADER = "X-Gol-Class"


class Request:
    """What a front hands the core: parsed request line + headers plus a
    lazy body reader (``read(n)``) — the core decides whether the body
    is ever read (the 413 path never reads it)."""

    __slots__ = ("method", "path", "headers", "read")

    def __init__(self, method: str, path: str, headers,
                 read: Callable[[int], bytes]):
        self.method = method
        self.path = path
        self.headers = headers          # any mapping with .get(name)
        self.read = read


class Response:
    """What the core hands back: status + body + content type, plus any
    extra headers and whether the connection must close after the write
    (the 413 path — an unread body poisons keep-alive framing)."""

    __slots__ = ("code", "body", "content_type", "headers", "close")

    def __init__(self, code: int, body: bytes, content_type: str,
                 headers: Optional[List[Tuple[str, str]]] = None,
                 close: bool = False):
        self.code = code
        self.body = body
        self.content_type = content_type
        self.headers = headers or []
        self.close = close


class StreamPlan:
    """A negotiated ``GET /stream/<sid>?every=k``: the aio front turns
    this into a chunked-transfer push stream of binary frames.  Fronts
    that cannot stream never see one — the core answers 501 for them.

    ``window`` (``(x0, y0, h, w)`` or None) restricts pushes to one
    viewport; ``delta`` switches the stream to dirty-tile delta frames
    with a keyframe on subscribe and every ``keyframe_every`` pushes."""

    __slots__ = ("sid", "every", "code", "window", "delta",
                 "keyframe_every")

    def __init__(self, sid: str, every: int, window=None,
                 delta: bool = False, keyframe_every: int = 64):
        self.sid = sid
        self.every = int(every)
        self.code = 200
        self.window = window
        self.delta = bool(delta)
        self.keyframe_every = int(keyframe_every)


def json_response(code: int, payload: dict, close: bool = False) -> Response:
    # the one JSON encoder both fronts share: json.dumps(payload).encode()
    return Response(code, json.dumps(payload).encode(),
                    "application/json", close=close)


class AppCore:
    """The transport-agnostic request handler.

    A front constructs one core at server build time and calls
    :meth:`dispatch` per request from whatever thread (or event loop
    callback) it likes — the core is stateless between requests apart
    from the shared request-id counter, and every manager verb it calls
    is already thread-safe.
    """

    def __init__(self, manager: Optional[SessionManager] = None,
                 verbose: bool = False,
                 profile_dir: Optional[str] = None,
                 max_body: int = DEFAULT_MAX_BODY):
        self.manager = manager if manager is not None else SessionManager()
        self.verbose = verbose
        self.profile_dir = profile_dir
        if max_body < 1:
            raise ValueError(f"max_body must be >= 1, got {max_body}")
        self.max_body = int(max_body)
        self.request_ids = itertools.count(1)
        self.obs = self.manager.obs
        # cluster membership (mpi_tpu_torch/cluster), attached by
        # serve_main after the socket binds; None routes every request
        # locally — the single-process behavior, byte-for-byte
        self.cluster = None

    # -- byte accounting (fronts call count_out for stream pushes too) -----

    def count_in(self, n: int, transport: str) -> None:
        if self.obs is not None and n:
            self.obs.http_bytes_in.inc(n, transport=transport)

    def count_out(self, n: int, transport: str) -> None:
        if self.obs is not None and n:
            self.obs.http_bytes_out.inc(n, transport=transport)

    # -- entry point -------------------------------------------------------

    def dispatch(self, req: Request, transport: str):
        """Handle one request; returns a :class:`Response` (or a
        :class:`StreamPlan` when ``transport == "aio"`` negotiated a
        stream).  Never raises — every failure maps to a structured
        JSON status."""
        rid = next(self.request_ids)
        obs = self.obs
        if obs is None:
            resp = self._guard(req, rid, None, transport)
        else:
            # one shared id per request: every span recorded while this
            # request is handled — here, in the watchdog worker, in the
            # batch leader — carries it (JSONL reconstructability).  The
            # trace context rides the same contextvar discipline: a
            # proxied hop continues the remote trace off its traceparent
            # header, anything else mints a fresh one at this edge.
            tctx = parse_traceparent(
                req.headers.get(TRACEPARENT_HEADER)) or mint()
            token = set_request_id(rid)
            ttoken = set_trace_context(tctx)
            t0 = time.perf_counter()
            try:
                with obs.span("http_request", method=req.method,
                              path=req.path) as sp:
                    resp = self._guard(req, rid, obs, transport)
                    sp.tag(code=resp.code)
                obs.http_requests.inc(method=req.method, code=resp.code)
                tel = obs.telemetry
                if tel is not None:
                    tel.http_digest.observe(time.perf_counter() - t0)
            finally:
                reset_trace_context(ttoken)
                reset_request_id(token)
            if not isinstance(resp, StreamPlan):
                # echo the served identity (the http_request span, so a
                # client following the /stream 307 re-propagates it and
                # the owner's spans stitch under this hop)
                resp.headers.append((TRACEPARENT_HEADER, format_traceparent(
                    sp.ctx if sp.ctx is not None else tctx)))
        if not isinstance(resp, StreamPlan):
            self.count_out(len(resp.body), transport)
        if self.verbose:
            print(f"[mpi_tpu] request {rid}: {req.method} {req.path} -> "
                  f"{resp.code}", file=sys.stderr)
        return resp

    # -- request plumbing --------------------------------------------------

    def _content_length(self, req: Request) -> int:
        raw = req.headers.get("Content-Length")
        if not raw:
            return 0
        try:
            n = int(raw)
        except (TypeError, ValueError):
            raise ConfigError(f"Content-Length must be an integer, "
                              f"got {raw!r}")
        if n < 0:
            raise ConfigError(f"Content-Length must be >= 0, got {n}")
        return n

    def _raw_body(self, req: Request, transport: str) -> bytes:
        n = self._content_length(req)
        if n == 0:
            return b""
        data = req.read(n)
        self.count_in(len(data), transport)
        return data

    def _body(self, req: Request, transport: str) -> dict:
        raw = self._raw_body(req, transport)
        if not raw:
            return {}
        try:
            data = json.loads(raw)
        except json.JSONDecodeError as e:
            raise ConfigError(f"request body is not valid JSON: {e}")
        if not isinstance(data, dict):
            raise ConfigError("request body must be a JSON object")
        return data

    def _timeout_override(self, req: Request, body: dict) -> Optional[float]:
        """The request's explicit deadline override, or None to use the
        server default: ``?timeout_s=`` wins over a ``timeout_s`` body
        key.  (It is a transport parameter, not part of the board spec —
        the create body's strict key check never sees it.)"""
        qs = parse_qs(urlsplit(req.path).query)
        raw = qs["timeout_s"][0] if "timeout_s" in qs else body.pop(
            "timeout_s", None)
        if raw is None:
            return None
        try:
            return float(raw)
        except (TypeError, ValueError):
            raise ConfigError(f"timeout_s must be a number, got {raw!r}")

    def _query_flag(self, req: Request, name: str) -> bool:
        """A boolean query parameter (``?async=1``, ``?wait=true``)."""
        qs = parse_qs(urlsplit(req.path).query)
        return (qs.get(name, ["0"])[0].lower() in ("1", "true", "yes"))

    def _wants_binary(self, req: Request) -> bool:
        return wire.GRID_MEDIA_TYPE in (req.headers.get("Accept") or "")

    def _viewport(self, req: Request) -> Optional[Tuple[int, int, int, int]]:
        """The request's viewport ``(x0, y0, h, w)`` from its ``x0``,
        ``y0``, ``h``, ``w`` query parameters, or None when none are
        present.  Partial windows are an error — a typo'd parameter must
        not silently serve the full board."""
        qs = parse_qs(urlsplit(req.path).query)
        names = ("x0", "y0", "h", "w")
        present = [n for n in names if n in qs]
        if not present:
            return None
        missing = [n for n in names if n not in qs]
        if missing:
            raise ConfigError(
                f"viewport needs all of x0,y0,h,w (missing: "
                f"{','.join(missing)})")
        vals = []
        for n in names:
            raw = qs[n][0]
            try:
                vals.append(int(raw))
            except (TypeError, ValueError):
                raise ConfigError(f"{n} must be an int, got {raw!r}")
        return tuple(vals)

    def _sends_binary(self, req: Request) -> bool:
        ct = (req.headers.get("Content-Type") or "").split(";")[0].strip()
        return ct == wire.GRID_MEDIA_TYPE

    def _route(self, req: Request):
        """(kind, session_id, verb) from the path."""
        parts = [p for p in req.path.split("?")[0].split("/") if p]
        if parts == ["healthz"]:
            return "healthz", None, None
        if parts == ["stats"]:
            return "stats", None, None
        if parts == ["metrics"]:
            return "metrics", None, None
        if parts == ["usage"]:
            return "usage", None, None
        if parts == ["slo"]:
            return "slo", None, None
        if parts == ["debug", "profile"]:
            return "profile", None, None
        if parts == ["debug", "timeseries"]:
            return "timeseries", None, None
        if parts == ["debug", "flights"]:
            return "flights", None, None
        if parts == ["debug", "anomalies"]:
            return "anomalies", None, None
        if len(parts) == 3 and parts[:2] == ["debug", "trace"]:
            return "trace", parts[2], None      # parts[2] is the trace id
        if parts and parts[0] == "cluster":
            # served only in cluster mode (self.cluster set); otherwise
            # falls through _handle to the usual structured 404
            if len(parts) == 1:
                return "cluster", None, None
            if len(parts) == 2:
                return "cluster", None, parts[1]
        if len(parts) == 2 and parts[0] == "result":
            return "result", parts[1], None     # parts[1] is the ticket id
        if len(parts) == 2 and parts[0] == "stream":
            return "stream", parts[1], None
        if parts and parts[0] == "sessions":
            if len(parts) == 1:
                return "sessions", None, None
            if len(parts) == 2:
                return "session", parts[1], None
            if len(parts) == 3:
                return "session", parts[1], parts[2]
        return "unknown", None, None

    # -- the guarded handler (routing + error mapping) ---------------------

    def _guard(self, req: Request, rid: int, obs, transport: str):
        kind, sid, verb = self._route(req)
        try:
            return self._handle(req, rid, obs, transport, kind, sid, verb)
        except wire.WireError as e:
            return json_response(400, {"error": str(e)})
        except KeyError:
            what = "ticket" if kind == "result" else "session"
            return json_response(404, {"error": f"no {what} {sid!r}"})
        except AdmissionReject as e:
            # admission backpressure (quota, session cap, shed): 429
            # with the unified structured body plus the tenant, and a
            # Retry-After sized to when the window actually frees
            payload = {"error": str(e), "tenant": e.tenant,
                       "request_id": rid}
            ctx = current_trace_context()
            if ctx is not None:
                payload["trace_id"] = ctx.trace_id
            resp = json_response(429, payload)
            resp.headers.append(retry_after_header(e.retry_after_s))
            return resp
        except TicketQueueFullError as e:
            # queue-full backpressure: same 503 body as before, now with
            # the Retry-After every backpressure rejection carries — one
            # dispatch round (plus slack) usually frees a slot
            payload = {"error": str(e), "request_id": rid}
            ctx = current_trace_context()
            if ctx is not None:
                payload["trace_id"] = ctx.trace_id
            resp = json_response(503, payload)
            resp.headers.append(retry_after_header(1.0))
            return resp
        except StorageDegradedError as e:
            # the storage plane is degraded and the --state-degrade
            # policy blocks this verb: same structured-503 contract as
            # every other backpressure answer, with Retry-After sized
            # to the persistence retry backoff — never a traceback
            payload = {"error": str(e), "persistence": "degraded",
                       "request_id": rid}
            ctx = current_trace_context()
            if ctx is not None:
                payload["trace_id"] = ctx.trace_id
            resp = json_response(503, payload)
            resp.headers.append(retry_after_header(e.retry_after_s))
            return resp
        except (DeadlineError, EngineUnavailableError,
                EngineStepError) as e:
            # fault-tolerance outcomes: the session survives; 503 tells
            # the client "try again / try later", never "you sent garbage"
            payload = {"error": str(e), "request_id": rid}
            ctx = current_trace_context()
            if ctx is not None:
                payload["trace_id"] = ctx.trace_id
            return json_response(503, payload)
        except (ConfigError, ValueError) as e:
            return json_response(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — the structured-500 backstop
            # a bug must answer structured JSON on a live connection,
            # never a stock HTML traceback page.  The traceback goes to
            # stderr under the request id, not the wire.
            print(f"[mpi_tpu] request {rid}: unhandled "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            traceback.print_exc(file=sys.stderr)
            payload = {
                "error": f"internal server error ({type(e).__name__})",
                "request_id": rid,
            }
            ctx = current_trace_context()
            if ctx is not None:
                # the client-side half of log↔trace correlation: this id
                # keys GET /debug/trace/<trace_id> on any node
                payload["trace_id"] = ctx.trace_id
            if obs is not None:
                # flush the evidence: the ring (or live --trace-log)
                # holds the request's spans up to the failure point
                dump = obs.tracer.dump_on_crash(
                    f"request {rid}: {type(e).__name__}: {e}")
                if dump:
                    payload["trace_dump"] = dump
                    print(f"[mpi_tpu] request {rid}: trace dumped to "
                          f"{dump}", file=sys.stderr)
                fl = obs.flight
                if fl is not None:
                    # the flight ring rides the same crash evidence:
                    # the last N dispatches, attributed, land beside
                    # the trace dump
                    base = dump or os.path.join(
                        tempfile.gettempdir(),
                        f"mpi_tpu_trace_crash_{os.getpid()}.jsonl")
                    fdump = base + ".flights.jsonl"
                    try:
                        fl.dump(fdump)
                        payload["flight_dump"] = fdump
                    except OSError:
                        pass
            return json_response(500, payload)

    def _handle(self, req: Request, rid: int, obs, transport: str,
                kind: str, sid: Optional[str], verb: Optional[str]):
        mgr = self.manager
        method = req.method
        # body bound FIRST — before any read, any route work that might
        # read, and without trusting the route to exist (an oversized
        # body on a bogus path is still an oversized body)
        n = self._content_length(req)
        if n > self.max_body:
            return json_response(413, {
                "error": f"request body is {n} bytes; the server accepts "
                         f"at most {self.max_body} (--http-max-body)",
                "max_body": self.max_body,
            }, close=True)
        cluster = self.cluster
        forced_sid = None
        if cluster is not None:
            if kind == "cluster":
                return self._cluster_endpoint(req, method, verb, transport)
            if req.headers.get(FORWARDED_HEADER):
                # one hop max: a forwarded request is served HERE even
                # if routing views disagree — a stale table can cost a
                # 404, never a proxy loop
                forced_sid = req.headers.get(SESSION_ID_HEADER)
            else:
                routed, forced_sid = self._cluster_route(
                    req, transport, kind, sid, method)
                if routed is not None:
                    return routed
        if kind == "metrics" and method == "GET":
            if obs is None:
                return json_response(404, {
                    "error": "observability is disabled (--no-obs)"})
            if OPENMETRICS_MEDIA_TYPE in (req.headers.get("Accept") or ""):
                # negotiated upgrade only: exemplars ride OpenMetrics;
                # the default Prometheus text stays byte-identical
                text = obs.render_metrics(openmetrics=True)
                return Response(
                    200, text.encode("utf-8"),
                    f"{OPENMETRICS_MEDIA_TYPE}; version=1.0.0; "
                    f"charset=utf-8")
            text = obs.render_metrics()
            return Response(200, text.encode("utf-8"),
                            "text/plain; version=0.0.4; charset=utf-8")
        if kind == "trace" and method == "GET" and sid is not None:
            if obs is None:
                return json_response(404, {
                    "error": "observability is disabled (--no-obs)"})
            return self._trace_fetch(req, sid)
        if kind == "usage" and method == "GET":
            # same off-switch contract as /metrics: usage metering rides
            # the obs handle, so --no-obs answers the same structured 404
            if obs is None:
                return json_response(404, {
                    "error": "observability is disabled (--no-obs)"})
            return json_response(200, mgr.usage())
        if kind in ("slo", "timeseries") and method == "GET":
            # armed-only surfaces: --no-obs answers the usual
            # structured 404, and an instrumented-but-unarmed server
            # answers a 404 naming the flag — the endpoints exist only
            # when the sampler exists, mirroring the scrape's armed-only
            # slo families
            if obs is None:
                return json_response(404, {
                    "error": "observability is disabled (--no-obs)"})
            if obs.telemetry is None:
                return json_response(404, {
                    "error": "telemetry is not armed "
                             "(--telemetry-interval-s)"})
            if kind == "slo":
                return json_response(200, mgr.slo())
            return self._timeseries(req, obs.telemetry)
        if kind in ("flights", "anomalies") and method == "GET":
            # armed-only surfaces, same contract as /slo:
            # --no-obs answers the structured 404; an instrumented-but-
            # unarmed server answers a 404 naming the arming flag
            if obs is None:
                return json_response(404, {
                    "error": "observability is disabled (--no-obs)"})
            if kind == "flights":
                if obs.flight is None:
                    return json_response(404, {
                        "error": "flight recorder is not armed "
                                 "(--flight-recorder)"})
                return self._flights(req, obs.flight)
            if obs.anomaly is None:
                return json_response(404, {
                    "error": "anomaly detection is not armed "
                             "(--anomaly-detect)"})
            return json_response(200, obs.anomaly.snapshot())
        if kind == "profile" and method == "POST":
            return self._profile(req)
        if kind == "healthz" and method == "GET":
            health = mgr.health()
            # a draining node still SERVES (clients and proxy hops keep
            # working) but the probe answers 503 so load balancers
            # rotate it out; the payload says why
            code = (200 if health["ok"] and not health.get("draining")
                    else 503)
            return json_response(code, health)
        if kind == "stats" and method == "GET":
            return json_response(200, mgr.stats())
        if kind == "sessions" and method == "POST":
            body = self._body(req, transport)
            timeout_s = self._timeout_override(req, body)
            tenant = None
            if mgr.admission is not None:
                # tenancy binds at create: the header's tenant (default
                # when absent) owns the session, gated by its
                # concurrency cap inside the manager
                tenant = mgr.admission.resolve(
                    req.headers.get(TENANT_HEADER))
            out = mgr.create(body, timeout_s=timeout_s, sid=forced_sid,
                             tenant=tenant)
            if cluster is not None:
                cluster.record_route(out["id"])
            return json_response(200, out)
        if kind == "result" and method == "GET" and sid is not None:
            result = mgr.ticket_result(
                sid, wait=self._query_flag(req, "wait"),
                timeout_s=self._timeout_override(req, {}))
            if result.get("status") == "done" and self._wants_binary(req):
                # the ticket's outcome as one binary frame of the
                # session's CURRENT grid (which may be further along
                # than this ticket if later tickets already committed —
                # same read-your-ticket semantics as snapshot-after-wait)
                return self._binary_snapshot(result["id"], req, transport)
            return json_response(200, result)
        if kind == "stream" and method == "GET" and sid is not None:
            if transport != "aio":
                return json_response(501, {
                    "error": "streaming needs the selector front "
                             "(start the server with --front aio)"})
            session = mgr.get(sid)      # unknown session -> 404 at setup
            qs = parse_qs(urlsplit(req.path).query)
            raw = qs["every"][0] if "every" in qs else "1"
            try:
                every = int(raw)
            except (TypeError, ValueError):
                raise ConfigError(f"every must be an int, got {raw!r}")
            if every < 1:
                raise ConfigError(f"every must be >= 1, got {every}")
            window = self._viewport(req)
            if window is not None:
                # validate NOW so a bad viewport answers 400 at setup,
                # never a dead stream later
                cfg = session.config
                mgr.window_rects(window[0], window[1], window[2],
                                 window[3], cfg.rows, cfg.cols,
                                 cfg.boundary)
            delta = self._query_flag(req, "delta")
            raw_k = qs.get("keyframe_every", ["64"])[0]
            try:
                keyframe_every = int(raw_k)
            except (TypeError, ValueError):
                raise ConfigError(
                    f"keyframe_every must be an int, got {raw_k!r}")
            if keyframe_every < 1:
                raise ConfigError(
                    f"keyframe_every must be >= 1, got {keyframe_every}")
            return StreamPlan(sid, every, window=window, delta=delta,
                              keyframe_every=keyframe_every)
        if kind == "session" and sid is not None:
            if method == "POST" and verb == "step":
                body = self._body(req, transport)
                timeout_s = self._timeout_override(req, body)
                steps = body.get("steps", 1)
                if not isinstance(steps, int):
                    raise ConfigError(f"steps must be an int, got {steps!r}")
                # the admission decision runs BEFORE either step path —
                # an over-quota or shed request must never reach device
                # dispatch (no device_dispatch span, no ledger debit)
                qos = mgr.admission_check(
                    sid, steps,
                    tenant=req.headers.get(TENANT_HEADER),
                    qos=req.headers.get(CLASS_HEADER),
                ) if mgr.admission is not None else None
                if self._query_flag(req, "async") or bool(body.get("async")):
                    return json_response(200, mgr.step_async(
                        sid, steps, timeout_s=timeout_s, qos=qos))
                return json_response(
                    200, mgr.step(sid, steps, timeout_s=timeout_s))
            if method == "PUT" and verb == "board":
                return self._write_board(req, sid, transport)
            if method == "GET" and verb in ("snapshot", "board"):
                # /board is the windowed-read alias of /snapshot: both
                # accept ?x0=&y0=&h=&w= and serve O(viewport) bytes
                timeout_override = self._timeout_override(req, {})
                window = self._viewport(req)
                if window is not None:
                    return self._window_snapshot(
                        sid, req, transport, window,
                        timeout_s=timeout_override)
                if self._wants_binary(req):
                    return self._binary_snapshot(sid, req, transport,
                                                 timeout_s=timeout_override)
                grid, generation, config = mgr.snapshot_array(
                    sid, timeout_s=timeout_override)
                t0 = time.perf_counter()
                payload = {"id": sid, "generation": generation,
                           "rows": config.rows, "cols": config.cols,
                           "grid": format_grid_rows(grid)}
                body = json.dumps(payload).encode()
                self._observe_encode(t0, "json", transport)
                return Response(200, body, "application/json")
            if method == "GET" and verb == "density":
                return json_response(200, mgr.density(
                    sid, timeout_s=self._timeout_override(req, {})))
            if method == "DELETE" and verb is None:
                return json_response(200, mgr.close(
                    sid, timeout_s=self._timeout_override(req, {})))
        return json_response(404, {"error": f"no route {method} {req.path}"})

    # -- cluster routing (mpi_tpu_torch/cluster; self.cluster is None outside
    # cluster mode and none of this runs) ----------------------------------

    def _cluster_endpoint(self, req: Request, method: str,
                          verb: Optional[str], transport: str) -> Response:
        cluster = self.cluster
        if verb == "gossip" and method == "POST":
            if cluster.inbound_cut("gossip"):
                # the inbound half of an injected partition: refuse the
                # digest exactly as a severed link would
                return json_response(503, {
                    "error": "gossip partition injected", "ok": False})
            applied = cluster.apply_digest(self._body(req, transport))
            # push-pull: the reply carries OUR digest, so one initiated
            # round synchronizes both directions
            return json_response(200, {"ok": True, "applied": applied,
                                       "digest": cluster.digest()})
        if verb == "join" and method == "POST":
            addr = self._body(req, transport).get("node")
            if not isinstance(addr, str) or not addr.strip():
                raise ConfigError("join body needs a 'node' address")
            try:
                return json_response(200, cluster.handle_join(addr))
            except ValueError as e:
                raise ConfigError(f"bad join address {addr!r}: {e}")
        if verb == "adopt" and method == "POST":
            sids = self._body(req, transport).get("sids")
            if not isinstance(sids, list):
                raise ConfigError("adopt body needs a 'sids' list")
            return json_response(200, cluster.handle_adopt(sids))
        if verb == "drain" and method == "POST":
            return json_response(200, cluster.drain())
        if verb is None and method == "GET":
            return json_response(200, cluster.info())
        return json_response(404, {"error": f"no route {method} {req.path}"})

    def _cluster_route(self, req: Request, transport: str, kind: str,
                       sid: Optional[str], method: str):
        """(response, forced_sid): a :class:`Response` when the request
        belongs to a peer (proxied, or its failure mapped), else None
        with the locally-allocated session id for the create path."""
        cluster = self.cluster
        if kind == "sessions" and method == "POST":
            # the receiving front allocates the id, THEN places it — so
            # the id's owner and the serving process always agree
            new_sid = cluster.new_session_id()
            owner = cluster.owner_addr(new_sid)
            if owner == cluster.id:
                return None, new_sid
            resp = self._proxy_to(owner, req, transport,
                                  extra={SESSION_ID_HEADER: new_sid},
                                  missing=("session", new_sid))
            if resp.code == 200:
                # the placement decision was made HERE — record it here
                # too, so the route outlives an owner that dies before
                # its first gossip round spreads it (failover adoption
                # scans the survivors' tables for the dead node's sids)
                cluster.record_route(new_sid, owner)
            return resp, None
        if kind in ("session", "stream") and sid is not None:
            owner = cluster.owner_addr(sid)
            if owner == cluster.id:
                return None, None
            if kind == "stream":
                # an open-ended push stream cannot be relayed hop-by-hop
                # without a parked thread per frame; redirect the client
                # to the owner instead
                return Response(
                    307, b"", "application/json",
                    headers=[("Location",
                              f"http://{owner}{req.path}")]), None
            return self._proxy_to(owner, req, transport,
                                  missing=("session", sid)), None
        if kind == "result" and sid is not None:
            owner = cluster.ticket_owner_addr(sid)
            if owner is not None:
                return self._proxy_to(owner, req, transport,
                                      missing=("ticket", sid)), None
            dead = cluster.dead_ticket_addr(sid)
            if dead is not None:
                # tickets are process-local and died with their owner;
                # answer the exact structured 404 without a doomed hop
                # (failover adoption restores sessions, never tickets)
                return json_response(404, {"error": f"no ticket {sid!r}",
                                           "peer": dead}), None
        return None, None

    def _proxy_to(self, owner: str, req: Request, transport: str,
                  extra: Optional[dict] = None,
                  missing: Optional[Tuple[str, str]] = None) -> Response:
        """Forward one request to ``owner`` and relay its response
        verbatim (the peer's structured errors ARE the answer)."""
        cluster = self.cluster
        raw = self._raw_body(req, transport)
        headers = {FORWARDED_HEADER: cluster.id}
        for name in ("Content-Type", "Accept", TENANT_HEADER, CLASS_HEADER):
            # tenancy must survive the hop: the owning node runs the
            # admission decision, and it needs the caller's headers
            value = req.headers.get(name)
            if value:
                headers[name] = value
        if raw:
            headers["Content-Length"] = str(len(raw))
        headers.update(extra or {})
        if self.obs is not None:
            # the hop is itself a span; the traceparent sent carries ITS
            # id, so the owner's http_request stitches under this hop
            with self.obs.span("proxy_hop", peer=owner, method=req.method,
                               path=req.path) as sp:
                ctx = current_trace_context()
                if ctx is not None:
                    headers[TRACEPARENT_HEADER] = format_traceparent(ctx)
                resp = self._proxy_send(owner, req, raw, headers, missing)
                sp.tag(code=resp.code)
            return resp
        return self._proxy_send(owner, req, raw, headers, missing)

    def _proxy_send(self, owner: str, req: Request, raw: bytes,
                    headers: dict,
                    missing: Optional[Tuple[str, str]]) -> Response:
        """One proxy hop, hardened: idempotent verbs (GET — snapshots,
        ticket reads) retry ``--proxy-retries`` times with doubling
        backoff before giving up; non-idempotent ones fail after the
        first attempt (a retried step could double-commit).  The final
        503 carries ``Retry-After`` sized to the gossip interval — by
        then either the peer answered a heartbeat or failover has begun
        re-homing its sessions."""
        cluster = self.cluster
        attempts = 1 + (cluster.proxy_retries if req.method == "GET" else 0)
        err: Optional[PeerUnreachable] = None
        for attempt in range(attempts):
            if attempt:
                time.sleep(cluster.proxy_backoff_s * (2 ** (attempt - 1)))
            try:
                cluster.net_fault("proxy", owner)
                status, ctype, data = proxy_request(
                    owner, req.method, req.path, raw, headers,
                    timeout_s=cluster.proxy_timeout_s)
                return Response(status, data, ctype)
            except PeerUnreachable as e:
                err = e
        what, ident = missing or ("resource", "?")
        if what == "ticket":
            # the 404-after-restart ticket contract extended across
            # the slice: a dead owner's tickets answer the same
            # structured 404 a restarted single process would
            return json_response(404, {"error": f"no ticket {ident!r}",
                                       "peer": owner})
        resp = json_response(503, {"error": str(err), "peer": owner})
        resp.headers = [("Retry-After",
                         str(max(1, math.ceil(cluster.interval_s))))]
        return resp

    # -- telemetry history (GET /debug/timeseries) -------------------------

    def _timeseries(self, req: Request, tel) -> Response:
        """``?series=&window=`` over the recorder's rings: no ``series``
        lists what is recorded; with one, counters render as rates and
        gauges raw, timestamps monotone non-decreasing by construction
        (samples append in clock order)."""
        from mpi_tpu_torch.obs.timeseries import WINDOW_S

        qs = parse_qs(urlsplit(req.path).query)
        window = qs.get("window", ["5m"])[0]
        if window not in WINDOW_S:
            raise ConfigError(
                f"window must be one of {sorted(WINDOW_S)}, "
                f"got {window!r}")
        name = qs.get("series", [None])[0]
        if name is None:
            return json_response(200, {
                "series": tel.series_names(),
                "windows": sorted(WINDOW_S, key=WINDOW_S.get),
                "interval_s": tel.interval_s,
                "stats": tel.stats(),
            })
        if name not in tel.KINDS:
            return json_response(404, {
                "error": f"no series {name!r}",
                "series": tel.series_names()})
        return json_response(200, {
            "series": name,
            "kind": tel.KINDS[name],
            "window": window,
            "interval_s": tel.interval_s,
            "points": tel.points(name, WINDOW_S[window]),
        })

    # -- dispatch flight records (GET /debug/flights) ----------------------

    def _flights(self, req: Request, flight) -> Response:
        """``?session=&signature=&slower_than=&trace=&limit=`` over the
        flight ring (oldest first after filtering).  ``trace`` matches a
        record's own trace id or any of its batch-rider links."""
        qs = parse_qs(urlsplit(req.path).query)
        session = qs.get("session", [None])[0]
        signature = qs.get("signature", [None])[0]
        trace = qs.get("trace", [None])[0]
        slower = qs.get("slower_than", [None])[0]
        if slower is not None:
            try:
                slower = float(slower)
            except (TypeError, ValueError):
                raise ConfigError(
                    f"slower_than must be a number, got {slower!r}")
        raw_limit = qs.get("limit", [None])[0]
        limit = None
        if raw_limit is not None:
            try:
                limit = int(raw_limit)
            except (TypeError, ValueError):
                raise ConfigError(
                    f"limit must be an int, got {raw_limit!r}")
        records = flight.snapshot(session=session, signature=signature,
                                  slower_than=slower, trace=trace,
                                  limit=limit)
        return json_response(200, {
            "stats": flight.stats(),
            "count": len(records),
            "flights": records,
        })

    # -- distributed trace assembly (GET /debug/trace/<trace_id>) ----------

    def _trace_fragment(self, trace_id: str) -> List[dict]:
        """This process's spans for one trace, node-stamped so stitched
        output says where each span ran.  Shared dispatch rounds carry
        riders as ``links`` (``trace_id:span_id``), not parents — a
        round linked to this trace is part of the story, so it rides
        along (it stitches as a root: related, unparented)."""
        node = self.cluster.id if self.cluster is not None else "local"
        prefix = trace_id + ":"
        out = []
        for rec in self.obs.tracer.snapshot():
            if rec.get("trace_id") == trace_id or any(
                    link.startswith(prefix)
                    for link in rec.get("links") or ()):
                rec["node"] = node
                out.append(rec)
        return out

    def _trace_fetch(self, req: Request, trace_id: str) -> Response:
        """Assemble one trace: the local fragment, plus (in cluster
        mode, when this request was not itself a fan-out hop) each live
        peer's fragment, stitched into one wall-clock-ordered tree.  A
        peer that is down — or dies mid-fetch — lands in ``partial``;
        the fetch itself never fails on a dead peer."""
        cluster = self.cluster
        forwarded = bool(req.headers.get(FORWARDED_HEADER))
        fanout = cluster is not None and not forwarded
        with self.obs.span("trace_fetch", target=trace_id, fanout=fanout):
            spans = self._trace_fragment(trace_id)
            nodes = [self.cluster.id if cluster is not None else "local"]
            partial: List[str] = []
            if fanout:
                for addr, state in cluster.health_block()["peers"].items():
                    if (not state["alive"]
                            and state["last_seen_age_s"] is not None):
                        # known-dead by heartbeat age: report, don't wait
                        # on a connect timeout
                        partial.append(addr)
                        continue
                    try:
                        status, _, data = proxy_request(
                            addr, "GET", f"/debug/trace/{trace_id}", b"",
                            {FORWARDED_HEADER: cluster.id},
                            timeout_s=cluster.timeout_s)
                        frag = json.loads(data) if status == 200 else None
                    except (PeerUnreachable, ValueError):
                        frag = None
                    if not isinstance(frag, dict):
                        partial.append(addr)
                        continue
                    spans.extend(s for s in frag.get("spans", [])
                                 if isinstance(s, dict))
                    nodes.append(addr)
            ordered, roots = stitch_spans(spans)
        return json_response(200, {
            "trace_id": trace_id,
            "nodes": nodes,
            "partial": partial,
            "complete": not partial,
            "spans": ordered,
            "tree": roots,
        })

    # -- wire-format helpers -----------------------------------------------

    def _observe_encode(self, t0: float, fmt: str, transport: str) -> None:
        if self.obs is not None:
            self.obs.wire_encode.observe(time.perf_counter() - t0,
                                         format=fmt, transport=transport)

    def _observe_decode(self, t0: float, fmt: str, transport: str) -> None:
        if self.obs is not None:
            self.obs.wire_decode.observe(time.perf_counter() - t0,
                                         format=fmt, transport=transport)

    def _binary_snapshot(self, sid: str, req: Request, transport: str,
                         timeout_s: Optional[float] = None) -> Response:
        grid, generation, config = self.manager.snapshot_array(
            sid, timeout_s=timeout_s)
        t0 = time.perf_counter()
        frame = self.encode_grid_frame(grid, generation, config)
        self._observe_encode(t0, "binary", transport)
        return Response(200, frame, wire.GRID_MEDIA_TYPE)

    def encode_grid_frame(self, grid, generation, config) -> bytes:
        """One binary frame for a session grid (snapshot, ticket result,
        and the aio front's stream pushes all come through here)."""
        return wire.encode_frame(grid, generation=generation,
                                 rule=config.rule, boundary=config.boundary)

    def _window_snapshot(self, sid: str, req: Request, transport: str,
                         window: Tuple[int, int, int, int],
                         timeout_s: Optional[float] = None) -> Response:
        """One viewport read: O(viewport) device bytes (per-shard
        fetch inside the manager) and O(viewport) wire bytes (a v2
        windowed frame, or the JSON window shape)."""
        x0, y0, h, w = window
        grid, generation, config = self.manager.snapshot_window(
            sid, x0, y0, h, w, timeout_s=timeout_s)
        if self._wants_binary(req):
            t0 = time.perf_counter()
            frame = wire.encode_window_frame(
                grid, x0=x0, y0=y0,
                board_shape=(config.rows, config.cols),
                generation=generation, rule=config.rule,
                boundary=config.boundary)
            self._observe_encode(t0, "binary", transport)
            if self.obs is not None:
                self.obs.viewport_bytes.inc(len(frame),
                                            transport=transport)
            return Response(200, frame, wire.GRID_MEDIA_TYPE)
        t0 = time.perf_counter()
        payload = {"id": sid, "generation": generation,
                   "board_rows": config.rows, "board_cols": config.cols,
                   "x0": x0, "y0": y0, "rows": h, "cols": w,
                   "grid": format_grid_rows(grid)}
        body = json.dumps(payload).encode()
        self._observe_encode(t0, "json", transport)
        if self.obs is not None:
            self.obs.viewport_bytes.inc(len(body), transport=transport)
        return Response(200, body, "application/json")

    def _write_board(self, req: Request, sid: str,
                     transport: str) -> Response:
        window = None
        if self._sends_binary(req):
            raw = self._raw_body(req, transport)
            t0 = time.perf_counter()
            grid, meta = wire.decode_frame(raw)
            self._observe_decode(t0, "binary", transport)
            if meta["is_delta"]:
                raise ConfigError(
                    "board writes take full or windowed frames, "
                    "not delta frames")
            if meta["window"] is not None:
                wx0, wy0, _, _ = meta["window"]
                window = (wx0, wy0)
            generation = (meta["generation"] if meta["has_generation"]
                          else None)
            timeout_s = self._timeout_override(req, {})
        else:
            body = self._body(req, transport)
            timeout_s = self._timeout_override(req, body)
            if "grid" not in body:
                raise ConfigError('board write needs a "grid" key '
                                  "(or a binary frame body)")
            t0 = time.perf_counter()
            grid = parse_grid_rows(body["grid"])
            self._observe_decode(t0, "json", transport)
            x0, y0 = body.get("x0"), body.get("y0")
            if (x0 is None) != (y0 is None):
                raise ConfigError(
                    "a region write needs both x0 and y0")
            if x0 is not None:
                if not isinstance(x0, int) or not isinstance(y0, int):
                    raise ConfigError(
                        f"x0/y0 must be ints, got {x0!r}/{y0!r}")
                window = (x0, y0)
            generation = body.get("generation")
            if generation is not None and not isinstance(generation, int):
                raise ConfigError(
                    f"generation must be an int, got {generation!r}")
        if window is not None:
            return json_response(200, self.manager.write_window(
                sid, window[0], window[1], grid, generation=generation,
                timeout_s=timeout_s))
        return json_response(200, self.manager.write_board(
            sid, grid, generation=generation, timeout_s=timeout_s))

    def _profile(self, req: Request) -> Response:
        logdir = self.profile_dir
        if logdir is None:
            return json_response(404, {
                "error": "profiling is disabled "
                         "(start the server with --profile-dir)"})
        qs = parse_qs(urlsplit(req.path).query)
        raw = qs["secs"][0] if "secs" in qs else "1"
        try:
            secs = float(raw)
        except (TypeError, ValueError):
            raise ConfigError(f"secs must be a number, got {raw!r}")
        from mpi_tpu_torch.obs.profile import run_profile

        result = run_profile(logdir, secs)
        return json_response(200 if result["ok"] else 503, result)
