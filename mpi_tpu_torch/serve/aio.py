"""Selectors-based non-blocking HTTP front end (``--front aio``).

The threaded front burns one ``ThreadingHTTPServer`` thread per open
connection, so ten thousand idle ``GET /result/<t>?wait=1`` pollers are
ten thousand blocked threads.  This front inverts the model: ONE event
loop (stdlib ``selectors``) owns every socket and buffer, a small
:class:`~concurrent.futures.ThreadPoolExecutor` runs the blocking
session verbs (device dispatch stays on the existing SessionManager /
AsyncDispatcher worker threads — the loop never holds a session lock),
and the two places a thread used to idle become parked state:

* **Ticket waiters** — ``GET /result/<t>?wait=1`` registers a
  resolution callback on the ticket
  (:meth:`AsyncDispatcher.on_resolve`) and parks the socket.  Ticket
  resolution wakes exactly the sockets waiting on that ticket; a wait
  budget that expires first unparks and answers the same "pending"
  payload the threaded front would.  Ten thousand parked waiters cost
  ten thousand sockets and zero threads.
* **Live viewers** — ``GET /stream/<sid>?every=k`` answers a chunked
  ``application/x-gol-grid-stream`` response and parks; a step-commit
  listener on the manager (:meth:`SessionManager.add_step_listener`)
  marks the stream dirty and the loop pushes one binary frame per k
  generations.  A slow consumer never blocks a step and never builds an
  unbounded queue: when a connection's write buffer is over
  ``--stream-buffer-kib``, new frames overwrite a one-slot
  ``pending_frame`` (drop-to-latest) until the socket drains.

Request semantics (routes, validation, error shapes, the binary frame
protocol, the 413 body bound) all live in
:class:`~mpi_tpu_torch.serve.transport.AppCore` — shared verbatim with the
threaded front, so the two cannot drift.

Threading rules (the loop's invariants):

* selector registration, connection state, timers: **loop thread only**;
* worker threads and ticket/step callbacks communicate with the loop
  exclusively via :meth:`_enqueue` (action deque + socketpair self-wake)
  — both are non-blocking, so a resolution callback firing inside the
  dispatch loop's commit (session locks held) costs an append and one
  pipe byte;
* the loop itself never blocks: accept/recv/send are non-blocking, and
  anything that could wait (session locks, watchdogs, device syncs)
  runs on the pool.
"""

from __future__ import annotations

import heapq
import io
import selectors
import socket
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from http.client import responses as _REASONS
from typing import Dict, List, Optional, Set
from urllib.parse import parse_qs, urlencode, urlsplit

from mpi_tpu_torch.serve import wire
from mpi_tpu_torch.serve.session import SessionManager
from mpi_tpu_torch.serve.transport import (
    AppCore, DEFAULT_MAX_BODY, Request, Response, StreamPlan, json_response,
)

DEFAULT_STREAM_BUFFER = 256 << 10       # per-socket write-buffer bound
MAX_HEADER = 64 << 10                   # request head must fit in this
_RECV_CHUNK = 1 << 16


class _Headers(dict):
    """Lower-cased header map with a case-insensitive ``get`` (the core
    asks for ``Content-Length``/``Accept`` in canonical case)."""

    def get(self, name, default=None):  # noqa: A003 — mapping contract
        return dict.get(self, name.lower(), default)


class _Conn:
    """One client connection's entire state (loop thread only)."""

    __slots__ = ("sock", "fd", "rbuf", "wbuf", "pending", "busy", "keep",
                 "close_after", "parked", "stream", "pending_frame",
                 "inflight", "closed")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.fd = sock.fileno()
        self.rbuf = bytearray()
        self.wbuf = bytearray()
        self.pending = None             # parsed head awaiting its body
        self.busy = False               # a request is being handled
        self.keep = True                # keep-alive after current response
        self.close_after = False        # close once wbuf drains
        self.parked = None              # ticket-waiter state
        self.stream = None              # stream state
        self.pending_frame = None       # drop-to-latest slot (frame, gen)
        self.inflight = False           # a pool job owns this conn
        self.closed = False


class AioServer:
    """The event-loop server.  Mirrors the ``ThreadingHTTPServer``
    surface the CLI and tests drive: ``server_address``,
    ``serve_forever()``, ``shutdown()`` (thread-safe), and
    ``server_close()``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 manager: Optional[SessionManager] = None,
                 verbose: bool = False,
                 profile_dir: Optional[str] = None,
                 max_body: int = DEFAULT_MAX_BODY,
                 workers: int = 4,
                 stream_buffer: int = DEFAULT_STREAM_BUFFER):
        self.core = AppCore(manager, verbose=verbose,
                            profile_dir=profile_dir, max_body=max_body)
        self.manager = self.core.manager
        self.obs = self.core.obs
        self.verbose = verbose
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        self.workers = int(workers)
        self.stream_buffer = max(1, int(stream_buffer))

        self._listen = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listen.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listen.bind((host, port))
        self._listen.listen(128)
        self._listen.setblocking(False)
        self.server_address = self._listen.getsockname()

        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._listen, selectors.EVENT_READ,
                           ("listen", None))
        self._sel.register(self._wake_r, selectors.EVENT_READ,
                           ("wake", None))

        self._pool = ThreadPoolExecutor(max_workers=self.workers,
                                        thread_name_prefix="mpi_tpu_torch-aio")
        self._conns: Dict[int, _Conn] = {}
        self._actions: deque = deque()
        self._actions_lock = threading.Lock()
        self._timers: List[list] = []   # heap of [when, seq, fn-or-None]
        self._timer_seq = 0
        self._running = False
        self._shutdown_done = threading.Event()
        self._shutdown_done.set()       # not serving yet
        self._closed = False

        # streaming hub: sid -> conns; _stream_sids is the racily-read
        # fast-path filter for the step-listener (set mutated in the loop
        # thread only; a stale read costs one wasted action, never a miss
        # of a live stream — membership is re-checked in the loop)
        self._hub: Dict[str, Set[_Conn]] = {}
        self._stream_sids: Set[str] = set()
        self.manager.add_step_listener(self._on_step_commit)

        # counters (loop thread writes; /stats + scrape callbacks read)
        self.streams_opened = 0
        self.frames_pushed = 0
        self.frames_dropped = 0
        self.requests_handled = 0
        self.parked_total = 0
        self.resolved_dispatched = 0

        # parked-waiter fairness: a resolve burst (one batched commit can
        # resolve hundreds of parked tickets at once) must not flood the
        # small worker pool ahead of fresh requests.  Unparked waiters
        # queue here and drain FIFO, at most ``workers`` of them on the
        # pool at a time, so a new request's job is always behind a
        # bounded prefix of the burst instead of the whole of it.
        self._resolved_fifo: deque = deque()
        self._dispatching = 0           # request jobs on the pool now

        if self.obs is not None:
            m = self.obs.metrics
            m.gauge_fn("mpi_tpu_aio_open_connections",
                       "Sockets the aio front currently owns",
                       lambda: len(self._conns))
            m.gauge_fn("mpi_tpu_aio_parked_waiters",
                       "Ticket waiters parked as sockets (zero threads)",
                       lambda: self._count_conns(
                           lambda c: c.parked is not None))
            m.gauge_fn("mpi_tpu_aio_active_streams",
                       "Open chunked grid streams",
                       lambda: self._count_conns(
                           lambda c: c.stream is not None))
            m.counter_fn("mpi_tpu_aio_frames_pushed_total",
                         "Binary frames pushed to stream consumers",
                         lambda: self.frames_pushed)
            m.counter_fn("mpi_tpu_aio_frames_dropped_total",
                         "Stream frames dropped to latest (slow consumer)",
                         lambda: self.frames_dropped)
            m.gauge_fn("mpi_tpu_aio_resolve_queue_depth",
                       "Unparked waiters queued behind the fairness "
                       "bound (FIFO, at most --aio-workers on the pool)",
                       lambda: len(self._resolved_fifo))

    def _count_conns(self, pred) -> int:
        # scrape-time read of loop-thread state: a concurrent mutation
        # can break dict iteration — retry, it settles immediately
        for _ in range(8):
            try:
                return sum(1 for c in list(self._conns.values()) if pred(c))
            except RuntimeError:
                continue
        return 0

    # -- cross-thread signalling ------------------------------------------

    def _enqueue(self, fn) -> None:
        """Hand ``fn`` to the loop thread (any thread; non-blocking)."""
        with self._actions_lock:
            self._actions.append(fn)
        try:
            self._wake_w.send(b"x")
        except (BlockingIOError, OSError):
            pass                        # pipe full = wake already pending

    def _add_timer(self, delay_s: float, fn) -> list:
        self._timer_seq += 1
        entry = [time.monotonic() + max(0.0, delay_s), self._timer_seq, fn]
        heapq.heappush(self._timers, entry)
        return entry

    # -- the loop ----------------------------------------------------------

    def serve_forever(self) -> None:
        self._running = True
        self._shutdown_done.clear()
        try:
            while self._running:
                timeout = None
                if self._timers:
                    timeout = max(0.0,
                                  self._timers[0][0] - time.monotonic())
                for key, mask in self._sel.select(timeout):
                    kind, conn = key.data
                    if kind == "listen":
                        self._accept()
                    elif kind == "wake":
                        try:
                            while self._wake_r.recv(4096):
                                pass
                        except (BlockingIOError, OSError):
                            pass
                    else:
                        self._on_conn(conn, mask)
                self._run_timers()
                self._run_actions()
        finally:
            self._shutdown_done.set()

    def shutdown(self) -> None:
        """Stop ``serve_forever`` (thread-safe; returns once the loop
        has exited, matching ``socketserver``'s contract)."""
        self._running = False
        try:
            self._wake_w.send(b"x")
        except OSError:
            pass
        self._shutdown_done.wait(timeout=5.0)

    def server_close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._running = False
        self.manager.remove_step_listener(self._on_step_commit)
        for conn in list(self._conns.values()):
            self._close_conn(conn)
        for sock in (self._listen, self._wake_r, self._wake_w):
            try:
                sock.close()
            except OSError:
                pass
        try:
            self._sel.close()
        except (OSError, RuntimeError):
            pass
        self._pool.shutdown(wait=False)

    def _run_actions(self) -> None:
        while True:
            with self._actions_lock:
                if not self._actions:
                    return
                fn = self._actions.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 — one bad action, not the loop
                traceback.print_exc(file=sys.stderr)

    def _run_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0][0] <= now:
            entry = heapq.heappop(self._timers)
            fn = entry[2]
            if fn is None:
                continue                # cancelled
            try:
                fn()
            except Exception:  # noqa: BLE001
                traceback.print_exc(file=sys.stderr)

    # -- socket events -----------------------------------------------------

    def _accept(self) -> None:
        while True:
            try:
                sock, _addr = self._listen.accept()
            except (BlockingIOError, OSError):
                return
            sock.setblocking(False)
            try:
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                pass
            conn = _Conn(sock)
            self._conns[conn.fd] = conn
            self._sel.register(sock, selectors.EVENT_READ, ("conn", conn))

    def _set_write_interest(self, conn: _Conn, want: bool) -> None:
        if conn.closed:
            return
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if want
                                         else 0)
        try:
            self._sel.modify(conn.sock, events, ("conn", conn))
        except (KeyError, ValueError, OSError):
            pass

    def _on_conn(self, conn: _Conn, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_READ:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                data = None
            except OSError:
                return self._close_conn(conn)
            if data == b"":
                return self._close_conn(conn)
            if data:
                conn.rbuf += data
                if conn.stream is not None or conn.parked is not None:
                    # a parked/streaming client has nothing more to say;
                    # cap what a misbehaving one can make us buffer
                    if len(conn.rbuf) > MAX_HEADER:
                        return self._close_conn(conn)
                else:
                    self._process_rbuf(conn)
                    if conn.closed:
                        return
        if mask & selectors.EVENT_WRITE:
            self._flush(conn)

    def _close_conn(self, conn: _Conn) -> None:
        if conn.closed:
            return
        conn.closed = True
        if conn.parked is not None:
            info, conn.parked = conn.parked, None
            self._cancel_park(info)
        if conn.stream is not None:
            self._detach_stream(conn)
        self._conns.pop(conn.fd, None)
        try:
            self._sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass

    # -- HTTP/1.1 parsing --------------------------------------------------

    def _process_rbuf(self, conn: _Conn) -> None:
        while not (conn.busy or conn.close_after or conn.closed):
            if conn.pending is None:
                idx = conn.rbuf.find(b"\r\n\r\n")
                if idx < 0:
                    if len(conn.rbuf) > MAX_HEADER:
                        self._deliver(conn, json_response(431, {
                            "error": "request head exceeds 64 KiB"},
                            close=True))
                    return
                head = bytes(conn.rbuf[:idx]).decode("latin-1")
                lines = head.split("\r\n")
                parts = lines[0].split()
                if len(parts) != 3 or not parts[2].startswith("HTTP/"):
                    return self._deliver(conn, json_response(400, {
                        "error": f"malformed request line {lines[0]!r}"},
                        close=True))
                method, target, version = parts
                headers = _Headers()
                for line in lines[1:]:
                    name, sep, value = line.partition(":")
                    if sep:
                        headers[name.strip().lower()] = value.strip()
                raw_cl = headers.get("content-length")
                try:
                    clen = int(raw_cl) if raw_cl else 0
                except ValueError:
                    clen = -1           # unframeable; core answers the 400
                token = (headers.get("connection") or "").lower()
                keep = (token == "keep-alive" if version == "HTTP/1.0"
                        else token != "close")
                conn.pending = [method, target, headers, idx + 4, clen,
                                keep]
            method, target, headers, body_off, clen, keep = conn.pending
            if clen < 0 or clen > self.core.max_body:
                # bad framing or over the body bound: hand the core an
                # empty body (it answers 400/413 without reading) and
                # close — the unread body poisons keep-alive framing
                body = b""
                keep = False
                del conn.rbuf[:]
            else:
                if len(conn.rbuf) - body_off < clen:
                    return              # body still arriving
                body = bytes(conn.rbuf[body_off:body_off + clen])
                del conn.rbuf[:body_off + clen]
            conn.pending = None
            conn.keep = keep
            req = Request(method, target, headers, io.BytesIO(body).read)
            self._start_request(conn, req)

    # -- request handling --------------------------------------------------

    def _start_request(self, conn: _Conn, req: Request) -> None:
        conn.busy = True
        self.requests_handled += 1
        if self._try_park(conn, req):
            return
        self._submit(conn, req)

    def _submit(self, conn: _Conn, req: Request) -> None:
        conn.inflight = True
        self._dispatching += 1          # loop thread only

        def done(fut):
            try:
                resp = fut.result()
            except Exception as e:  # noqa: BLE001 — dispatch never raises,
                # but a belt under the suspenders keeps the loop alive
                traceback.print_exc(file=sys.stderr)
                resp = json_response(500, {
                    "error": f"internal server error ({type(e).__name__})"})
            self._enqueue(lambda: self._finish_request(conn, resp))

        self._pool.submit(self.core.dispatch, req,
                          "aio").add_done_callback(done)

    def _finish_request(self, conn: _Conn, resp) -> None:
        self._dispatching -= 1
        conn.inflight = False
        self._deliver(conn, resp)
        self._drain_resolved()          # a worker freed: next waiter

    def _deliver(self, conn: _Conn, resp) -> None:
        if conn.closed:
            return
        if isinstance(resp, StreamPlan):
            return self._start_stream(conn, resp)
        head = self._head(resp.code, resp.content_type,
                          length=len(resp.body), extra=resp.headers,
                          close=resp.close or not conn.keep)
        conn.wbuf += head + resp.body
        if resp.close or not conn.keep:
            conn.close_after = True
        conn.busy = False
        self._flush(conn)
        if not (conn.closed or conn.close_after):
            self._process_rbuf(conn)    # pipelined requests, in order

    @staticmethod
    def _head(code: int, content_type: str, length: Optional[int] = None,
              extra=(), close: bool = False, chunked: bool = False) -> bytes:
        lines = [f"HTTP/1.1 {code} {_REASONS.get(code, 'Unknown')}",
                 f"Content-Type: {content_type}"]
        if chunked:
            lines.append("Transfer-Encoding: chunked")
        else:
            lines.append(f"Content-Length: {length}")
        for name, value in extra:
            lines.append(f"{name}: {value}")
        if close:
            lines.append("Connection: close")
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")

    def _flush(self, conn: _Conn) -> None:
        if conn.closed:
            return
        while True:
            if (not conn.wbuf and conn.pending_frame is not None
                    and conn.stream is not None):
                # the socket drained: promote the drop-to-latest slot
                frame, gen = conn.pending_frame
                conn.pending_frame = None
                self._append_frame(conn, frame, gen)
            if (not conn.wbuf and conn.stream is not None
                    and conn.stream["key_pending"]):
                # delta-stream resync: the drop discarded a frame, so
                # fetch a fresh keyframe now that the socket drained
                conn.stream["key_pending"] = False
                self._request_frame(conn)
            if not conn.wbuf:
                break
            try:
                sent = conn.sock.send(conn.wbuf)
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                return self._close_conn(conn)
            if sent <= 0:
                break
            del conn.wbuf[:sent]
        if conn.wbuf:
            self._set_write_interest(conn, True)
        else:
            self._set_write_interest(conn, False)
            if conn.close_after:
                self._close_conn(conn)

    # -- parked ticket waiters ---------------------------------------------

    def _try_park(self, conn: _Conn, req: Request) -> bool:
        """Park ``GET /result/<t>?wait=1`` as a registered socket instead
        of a blocked thread.  Returns False when the request is not a
        waitable ticket read (including unknown tickets — the normal
        dispatch path owns the structured 404)."""
        dispatcher = self.manager.dispatcher
        if dispatcher is None or req.method != "GET":
            return False
        parts = [p for p in req.path.split("?")[0].split("/") if p]
        if len(parts) != 2 or parts[0] != "result":
            return False
        if not self.core._query_flag(req, "wait"):
            return False
        tid = parts[1]
        nowait = self._strip_wait(req)
        info = {"tid": tid, "req": nowait, "timer": None, "fn": None}

        def on_resolve(_ticket):
            # dispatch-loop thread, session locks possibly held: flag+wake
            self._enqueue(lambda: self._unpark(conn, info))

        info["fn"] = on_resolve
        conn.parked = info
        try:
            parked = dispatcher.on_resolve(tid, on_resolve)
        except KeyError:
            conn.parked = None
            return False
        except (ValueError, ConnectionError):
            conn.parked = None
            return False
        self.parked_total += 1
        if parked:
            try:
                budget = self.manager._budget(
                    self.core._timeout_override(req, {}))
            except Exception:  # noqa: BLE001 — bad timeout_s: let core 400
                self._cancel_park(info)
                conn.parked = None
                return False
            if budget is not None:
                info["timer"] = self._add_timer(
                    budget, lambda: self._unpark(conn, info))
        # already-resolved tickets ran on_resolve synchronously above —
        # the _unpark action is queued and will dispatch the read
        return True

    @staticmethod
    def _strip_wait(req: Request) -> Request:
        """The same read without ``wait`` — what a parked waiter
        dispatches after wake/timeout (the ticket is either resolved,
        giving the final payload, or the budget expired, giving the
        same "pending" answer the threaded front's timed-out wait
        returns)."""
        parts = urlsplit(req.path)
        qs = parse_qs(parts.query)
        qs.pop("wait", None)
        query = urlencode(qs, doseq=True)
        path = parts.path + (f"?{query}" if query else "")
        return Request(req.method, path, req.headers, io.BytesIO(b"").read)

    def _unpark(self, conn: _Conn, info: dict) -> None:
        if conn.closed or conn.parked is not info:
            return                      # stale wake (timeout + resolve race)
        conn.parked = None
        self._cancel_park(info)
        # fairness: never straight to the pool — through the FIFO, so a
        # resolve burst dispatches at most ``workers`` waiters at a time
        # and fresh requests interleave instead of starving behind it
        self._resolved_fifo.append((conn, info["req"]))
        self._drain_resolved()

    def _drain_resolved(self) -> None:
        """Dispatch queued unparked waiters FIFO while the pool has a
        free worker (loop thread only — no lock needed)."""
        while self._resolved_fifo and self._dispatching < self.workers:
            conn, req = self._resolved_fifo.popleft()
            if conn.closed:
                continue                # died while queued
            self.resolved_dispatched += 1
            self._submit(conn, req)

    def _cancel_park(self, info: dict) -> None:
        if info.get("timer") is not None:
            info["timer"][2] = None     # lazy-cancel in the heap
            info["timer"] = None
        dispatcher = self.manager.dispatcher
        if dispatcher is not None and info.get("fn") is not None:
            dispatcher.cancel_resolve(info["tid"], info["fn"])

    # -- streams -----------------------------------------------------------

    def _start_stream(self, conn: _Conn, plan: StreamPlan) -> None:
        # delta-stream state beyond the classic trio: ``prev`` is the
        # grid behind the last ENCODED frame (pool thread only — one job
        # in flight per connection), ``force_key``/``key_pending`` drive
        # the resync-after-drop protocol (a lost delta would silently
        # diverge the client's reconstruction, so a drop discards the
        # frame and schedules a keyframe once the socket drains)
        conn.stream = {"sid": plan.sid, "every": plan.every,
                       "last": None, "dirty": False,
                       "window": plan.window, "delta": plan.delta,
                       "kf": plan.keyframe_every, "prev": None,
                       "since_key": 0, "force_key": False,
                       "key_pending": False}
        conn.busy = True                # the stream owns this connection
        conn.wbuf += self._head(200, wire.STREAM_MEDIA_TYPE, chunked=True)
        self._hub.setdefault(plan.sid, set()).add(conn)
        self._stream_sids.add(plan.sid)
        self.streams_opened += 1
        self._flush(conn)
        self._request_frame(conn)       # first frame: the current grid

    def _detach_stream(self, conn: _Conn) -> None:
        st, conn.stream = conn.stream, None
        if st is None:
            return
        conns = self._hub.get(st["sid"])
        if conns is not None:
            conns.discard(conn)
            if not conns:
                del self._hub[st["sid"]]
                self._stream_sids.discard(st["sid"])

    def _on_step_commit(self, session) -> None:
        # manager step-listener: ANY thread, session lock typically held.
        # The set membership test is the cheap racy filter; everything
        # else happens on the loop thread.
        if session.id in self._stream_sids:
            sid = session.id
            self._enqueue(lambda: self._notify_streams(sid))

    def _notify_streams(self, sid: str) -> None:
        for conn in list(self._hub.get(sid, ())):
            if conn.stream is not None:
                conn.stream["dirty"] = True
                self._request_frame(conn)

    def _request_frame(self, conn: _Conn) -> None:
        """Fetch+encode the session's current grid (or viewport) on the
        pool, then deliver it to this stream (one job in flight per
        connection — a burst of commits coalesces into one fetch of the
        latest)."""
        if conn.inflight or conn.closed or conn.stream is None:
            return
        st = conn.stream
        st["dirty"] = False
        conn.inflight = True
        sid = st["sid"]
        core = self.core

        def job():
            try:
                if st["window"] is not None:
                    wx0, wy0, wh, ww = st["window"]
                    grid, gen, config = self.manager.snapshot_window(
                        sid, wx0, wy0, wh, ww)
                else:
                    grid, gen, config = self.manager.snapshot_array(sid)
                if st["delta"]:
                    # the every-gate runs BEFORE encoding here: a delta
                    # encoded but never delivered would still advance
                    # the base grid and diverge the client (st["last"]
                    # is a benign racy read — worst case one extra
                    # frame, never a missed diff)
                    last = st["last"]
                    if last is not None and gen < last + st["every"]:
                        self._enqueue(
                            lambda: self._deliver_frame(conn, None, gen))
                        return
                t0 = time.perf_counter()
                if core.obs is not None:
                    with core.obs.span("stream_push", sid=sid,
                                       generation=gen):
                        frame, fk = self._encode_stream_frame(
                            st, grid, gen, config)
                    core.obs.wire_encode.observe(
                        time.perf_counter() - t0, format="binary",
                        transport="aio")
                    if fk in ("key", "delta"):
                        core.obs.delta_frames.inc(kind=fk)
                    if st["window"] is not None:
                        core.obs.viewport_bytes.inc(len(frame),
                                                    transport="aio")
                else:
                    frame, fk = self._encode_stream_frame(
                        st, grid, gen, config)
                self._enqueue(
                    lambda: self._deliver_frame(conn, frame, gen))
            except Exception:  # noqa: BLE001 — session closed/deadline:
                # terminate the stream cleanly, the loop survives
                self._enqueue(lambda: self._end_stream(conn))

        self._pool.submit(job)

    def _encode_stream_frame(self, st: dict, grid, gen: int, config):
        """``(frame, kind)`` — the stream's next frame: a v1 full frame
        (plain streams), a v2 windowed frame (viewport streams), or a
        v2 keyframe/dirty-tile delta (delta streams; the delta base is
        the previously ENCODED grid, touched only by this connection's
        single in-flight pool job)."""
        window = st["window"]
        if not st["delta"]:
            if window is None:
                return (self.core.encode_grid_frame(grid, gen, config),
                        "full")
            return wire.encode_window_frame(
                grid, x0=window[0], y0=window[1],
                board_shape=(config.rows, config.cols), generation=gen,
                rule=config.rule, boundary=config.boundary), "window"
        x0, y0 = (window[0], window[1]) if window is not None else (0, 0)
        prev = st["prev"]
        need_key = (prev is None or st["force_key"]
                    or prev.shape != grid.shape
                    or st["since_key"] >= st["kf"])
        st["prev"] = grid
        if need_key:
            st["force_key"] = False
            st["since_key"] = 1
            return wire.encode_window_frame(
                grid, x0=x0, y0=y0,
                board_shape=(config.rows, config.cols), generation=gen,
                rule=config.rule, boundary=config.boundary), "key"
        st["since_key"] += 1
        tiles = wire.diff_tiles(prev, grid)
        return wire.encode_delta_frame(
            tiles, window=(x0, y0, grid.shape[0], grid.shape[1]),
            board_shape=(config.rows, config.cols), generation=gen,
            rule=config.rule, boundary=config.boundary), "delta"

    def _deliver_frame(self, conn: _Conn, frame: Optional[bytes],
                       gen: int) -> None:
        conn.inflight = False
        if conn.closed or conn.stream is None:
            return
        st = conn.stream
        if frame is None:
            # a delta stream's every-gate skipped this generation
            if st["dirty"]:
                self._request_frame(conn)
            return
        due = (st["delta"] or st["last"] is None
               or gen >= st["last"] + st["every"])
        if due:
            if len(conn.wbuf) > self.stream_buffer:
                if st["delta"]:
                    # a dropped delta would silently diverge the
                    # client's reconstruction: discard it and resync
                    # with a keyframe once the socket drains
                    st["force_key"] = True
                    st["key_pending"] = True
                    self.frames_dropped += 1
                else:
                    # slow consumer: drop to latest, never queue
                    # unboundedly
                    conn.pending_frame = (frame, gen)
                    self.frames_dropped += 1
            else:
                conn.pending_frame = None
                self._append_frame(conn, frame, gen)
                self._flush(conn)
        if conn.stream is not None and st["dirty"]:
            self._request_frame(conn)

    def _append_frame(self, conn: _Conn, frame: bytes, gen: int) -> None:
        chunk = b"%x\r\n" % len(frame) + frame + b"\r\n"
        conn.wbuf += chunk
        conn.stream["last"] = gen
        self.frames_pushed += 1
        self.core.count_out(len(chunk), "aio")

    def _end_stream(self, conn: _Conn) -> None:
        conn.inflight = False
        if conn.closed or conn.stream is None:
            return
        self._detach_stream(conn)
        conn.pending_frame = None
        conn.wbuf += b"0\r\n\r\n"       # terminal chunk
        conn.close_after = True
        self._flush(conn)

    # -- introspection -----------------------------------------------------

    def stats(self) -> dict:
        return {
            "open_connections": len(self._conns),
            "parked_waiters": self._count_conns(
                lambda c: c.parked is not None),
            "active_streams": self._count_conns(
                lambda c: c.stream is not None),
            "streams_opened": self.streams_opened,
            "frames_pushed": self.frames_pushed,
            "frames_dropped": self.frames_dropped,
            "requests_handled": self.requests_handled,
            "parked_total": self.parked_total,
            "resolved_dispatched": self.resolved_dispatched,
            "resolve_queue_depth": len(self._resolved_fifo),
            "workers": self.workers,
            "stream_buffer": self.stream_buffer,
        }


def make_aio_server(host: str = "127.0.0.1", port: int = 0,
                    manager: Optional[SessionManager] = None,
                    verbose: bool = False,
                    profile_dir: Optional[str] = None,
                    max_body: int = DEFAULT_MAX_BODY,
                    workers: int = 4,
                    stream_buffer: int = DEFAULT_STREAM_BUFFER) -> AioServer:
    """The aio twin of ``httpd.make_server`` (same call shape plus the
    aio-only knobs; ``port=0`` binds an ephemeral port)."""
    return AioServer(host, port, manager, verbose=verbose,
                     profile_dir=profile_dir, max_body=max_body,
                     workers=workers, stream_buffer=stream_buffer)
