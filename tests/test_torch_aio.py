"""The port's network front on the CPU: every scenario of the
reference's ``tests/test_aio.py`` against ``mpi_tpu_torch.serve`` — the
shared transport core, binary wire negotiation over HTTP, board writes,
the request-body bound, and the selectors front end (``serve/aio.py``):
keep-alive pipelining, parked ticket waiters, chunked binary streams, and
drop-to-latest backpressure.

Every server runs over a ``SessionManager(device="cpu")`` (the kernels'
plain versions; ``backend: "cuda"`` sessions are the card's engines),
binds port 0, and is shut down, its thread joined and its manager shut
down in the fixture's teardown.  Grids are held to the reference's
``serial_np`` oracle.
"""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu_torch.serve import wire
from mpi_tpu_torch.serve.aio import AioServer, _Conn, make_aio_server
from mpi_tpu_torch.serve.httpd import make_server
from mpi_tpu_torch.serve.session import SessionManager


# ----------------------------------------------------------------- helpers


def _start(srv):
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop(srv, thread):
    try:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
        assert not thread.is_alive()
    finally:
        srv.manager.shutdown()


@pytest.fixture()
def threaded():
    srv = make_server(port=0, manager=SessionManager(device="cpu"))
    thread = _start(srv)
    yield srv
    _stop(srv, thread)


@pytest.fixture()
def aio():
    srv = make_aio_server(port=0, manager=SessionManager(device="cpu"))
    thread = _start(srv)
    yield srv
    _stop(srv, thread)


def _park_signal(srv):
    """An event set once the aio front has parked a ticket waiter (its
    ``on_resolve`` registration answered True) — the wait the tests use
    instead of polling the front's counters."""
    dispatcher = srv.manager.dispatcher
    parked = threading.Event()
    real = dispatcher.on_resolve

    def on_resolve(tid, fn):
        out = real(tid, fn)
        if out:
            parked.set()
        return out

    dispatcher.on_resolve = on_resolve
    return parked


def _conn(srv, timeout=30):
    host, port = srv.server_address[:2]
    return http.client.HTTPConnection(host, port, timeout=timeout)


def _roundtrip(c, method, path, body=None, headers=None):
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    c.request(method, path, body=data, headers=headers or {})
    resp = c.getresponse()
    raw = resp.read()
    ctype = resp.getheader("Content-Type", "")
    if ctype.startswith("application/json"):
        return resp.status, json.loads(raw), raw
    return resp.status, raw, raw


def _create(c, **spec):
    status, created, _ = _roundtrip(c, "POST", "/sessions", spec)
    assert status == 200, created
    return created["id"]


# ------------------------------------------------- binary/JSON parity


@pytest.mark.parametrize("backend,boundary", [
    ("serial", "periodic"), ("serial", "dead"),
    ("cuda", "periodic"), ("cuda", "dead"),
])
def test_binary_snapshot_bit_identical_to_json(threaded, backend, boundary):
    c = _conn(threaded)
    sid = _create(c, rows=64, cols=64, backend=backend, boundary=boundary,
                  seed=13)
    _roundtrip(c, "POST", f"/sessions/{sid}/step", {"steps": 4})

    status, snap, _ = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot")
    assert status == 200 and snap["generation"] == 4
    status, frame, _ = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot",
                                  headers={"Accept": wire.GRID_MEDIA_TYPE})
    assert status == 200 and isinstance(frame, bytes)
    grid, meta = wire.decode_frame(frame)

    json_grid = np.array([[int(ch) for ch in row] for row in snap["grid"]],
                         dtype=np.uint8)
    assert np.array_equal(grid, json_grid)
    assert meta["generation"] == snap["generation"] == 4
    assert meta["has_generation"]
    assert meta["boundary"] == boundary
    assert (meta["rows"], meta["cols"]) == (64, 64)
    assert meta["rule_id"] != 0
    # bytes-on-wire: 1 bit/cell + the 32-byte header vs ~1 byte/cell JSON
    assert len(frame) == 32 + 64 * 64 // 8


def test_threaded_and_aio_answer_identical_json_bytes(threaded, aio):
    spec = {"rows": 48, "cols": 48, "backend": "serial", "seed": 21}
    bodies = {}
    for name, srv in (("threaded", threaded), ("aio", aio)):
        c = _conn(srv)
        sid = _create(c, **spec)
        _roundtrip(c, "POST", f"/sessions/{sid}/step", {"steps": 5})
        _, _, raw = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot")
        bodies[name] = raw
        c.close()
    assert bodies["threaded"] == bodies["aio"]


def test_ticket_result_binary_frame(aio):
    c = _conn(aio)
    sid = _create(c, rows=32, cols=32, backend="serial", seed=3)
    status, tk, _ = _roundtrip(c, "POST", f"/sessions/{sid}/step",
                               {"steps": 2, "async": True})
    assert status == 200 and tk["status"] == "pending"
    status, frame, _ = _roundtrip(
        c, "GET", f"/result/{tk['ticket']}?wait=1",
        headers={"Accept": wire.GRID_MEDIA_TYPE})
    assert status == 200 and isinstance(frame, bytes)
    grid, meta = wire.decode_frame(frame)
    assert meta["generation"] >= 2
    status, snap, _ = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot")
    json_grid = np.array([[int(ch) for ch in row] for row in snap["grid"]],
                         dtype=np.uint8)
    if snap["generation"] == meta["generation"]:
        assert np.array_equal(grid, json_grid)


# ----------------------------------------------------------- board writes


def test_board_write_json_then_binary(threaded):
    c = _conn(threaded)
    sid = _create(c, rows=32, cols=32, backend="serial", seed=1)

    rng = np.random.default_rng(5)
    world = rng.integers(0, 2, size=(32, 32)).astype(np.uint8)
    rows = ["".join(str(v) for v in row) for row in world]
    status, ack, _ = _roundtrip(c, "PUT", f"/sessions/{sid}/board",
                                {"grid": rows, "generation": 100})
    assert status == 200 and ack == {"id": sid, "generation": 100,
                                     "rows": 32, "cols": 32,
                                     "written": True}
    status, snap, _ = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot")
    got = np.array([[int(ch) for ch in row] for row in snap["grid"]],
                   dtype=np.uint8)
    assert snap["generation"] == 100 and np.array_equal(got, world)

    # stepping resumes from the written board, bit-identical to the oracle
    _roundtrip(c, "POST", f"/sessions/{sid}/step", {"steps": 3})
    status, snap, _ = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot")
    got = np.array([[int(ch) for ch in row] for row in snap["grid"]],
                   dtype=np.uint8)
    oracle = evolve_np(world, 3)
    assert np.array_equal(got, oracle) and snap["generation"] == 103

    # binary write: the frame's flagged generation rebases the session
    world2 = np.zeros((32, 32), dtype=np.uint8)
    world2[10, 10:13] = 1
    frame = wire.encode_frame(world2, generation=7)
    status, ack, _ = _roundtrip(
        c, "PUT", f"/sessions/{sid}/board", frame,
        headers={"Content-Type": wire.GRID_MEDIA_TYPE})
    assert status == 200 and ack["generation"] == 7
    status, frame2, _ = _roundtrip(c, "GET", f"/sessions/{sid}/snapshot",
                                   headers={"Accept": wire.GRID_MEDIA_TYPE})
    grid, meta = wire.decode_frame(frame2)
    assert meta["generation"] == 7 and np.array_equal(grid, world2)


def test_board_write_rejections(threaded):
    c = _conn(threaded)
    sid = _create(c, rows=16, cols=16, backend="serial", seed=2)
    # wrong shape
    bad = wire.encode_frame(np.ones((8, 8), dtype=np.uint8))
    status, err, _ = _roundtrip(c, "PUT", f"/sessions/{sid}/board", bad,
                                headers={"Content-Type":
                                         wire.GRID_MEDIA_TYPE})
    assert status == 400 and "shape" in err["error"]
    # garbage binary body
    status, err, _ = _roundtrip(c, "PUT", f"/sessions/{sid}/board",
                                b"not a frame at all padding padding",
                                headers={"Content-Type":
                                         wire.GRID_MEDIA_TYPE})
    assert status == 400 and "magic" in err["error"]
    # missing grid key
    status, err, _ = _roundtrip(c, "PUT", f"/sessions/{sid}/board",
                                {"generation": 3})
    assert status == 400 and "grid" in err["error"]
    # unknown session
    status, err, _ = _roundtrip(c, "PUT", "/sessions/nope/board",
                                {"grid": ["1"]})
    assert status == 404


# ------------------------------------------------------------ body bound


@pytest.mark.parametrize("front", ["threaded", "aio"])
def test_oversized_body_structured_413(front, threaded, aio):
    srv = threaded if front == "threaded" else aio
    c = _conn(srv, timeout=10)
    c.request("POST", "/sessions", body=b"",
              headers={"Content-Length": str(1 << 30)})
    resp = c.getresponse()
    body = json.loads(resp.read())
    assert resp.status == 413
    assert body["max_body"] == 64 << 20
    assert "--http-max-body" in body["error"]
    assert (resp.getheader("Connection") or "").lower() == "close"


def test_small_max_body_enforced():
    srv = make_aio_server(port=0, manager=SessionManager(device="cpu"),
                          max_body=128)
    thread = _start(srv)
    try:
        # under the bound: handled normally
        c = _conn(srv, timeout=10)
        body = b'{"rows": 16, "cols": 16, "backend": "serial"}'
        assert len(body) <= 128
        c.request("POST", "/sessions", body=body)
        assert c.getresponse().status == 200
        # over it: structured 413, body never parsed
        c2 = _conn(srv, timeout=10)
        c2.request("POST", "/sessions", body=b"x" * 129)
        resp = c2.getresponse()
        assert resp.status == 413
        assert json.loads(resp.read())["max_body"] == 128
    finally:
        _stop(srv, thread)


# ---------------------------------------------------- aio front mechanics


def test_aio_keepalive_pipelining(aio):
    c = _conn(aio)
    sid = _create(c, rows=16, cols=16, backend="serial", seed=4)
    c.close()
    host, port = aio.server_address[:2]
    s = socket.create_connection((host, port), timeout=10)
    # two requests in ONE send: the front must answer both, in order,
    # on the same connection (responses framed by Content-Length)
    s.sendall((f"GET /sessions/{sid}/density HTTP/1.1\r\nHost: x\r\n\r\n"
               f"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n").encode())
    s.settimeout(10)
    buf = b""
    while buf.count(b"HTTP/1.1 200") < 2:
        data = s.recv(65536)
        assert data, f"connection closed early with {buf!r}"
        buf += data
    first, second = buf.split(b"HTTP/1.1 200", 2)[1:]
    assert b'"density"' in first and b'"ok"' in second
    s.close()


def test_stream_chunked_reassembly(aio):
    c = _conn(aio)
    sid = _create(c, rows=32, cols=32, backend="serial", seed=6)
    host, port = aio.server_address[:2]
    s = socket.create_connection((host, port), timeout=10)
    s.sendall(f"GET /stream/{sid}?every=2 HTTP/1.1\r\nHost: x\r\n\r\n"
              .encode())
    s.settimeout(5)
    buf = b""
    while b"\r\n\r\n" not in buf:
        buf += s.recv(65536)
    head, buf = buf.split(b"\r\n\r\n", 1)
    assert b"200 OK" in head
    assert b"Transfer-Encoding: chunked" in head
    assert wire.STREAM_MEDIA_TYPE.encode() in head

    for _ in range(6):
        _roundtrip(c, "POST", f"/sessions/{sid}/step", {"steps": 1})
    deadline = time.monotonic() + 10
    frames = []
    remainder = b""
    while time.monotonic() < deadline and len(frames) < 3:
        try:
            data = s.recv(65536)
        except socket.timeout:
            break
        if not data:
            break
        buf += data
        # strip chunk framing, then reassemble frames across chunk
        # boundaries with the client half of the wire protocol
        payload = b""
        while True:
            i = buf.find(b"\r\n")
            if i < 0:
                break
            size = int(buf[:i], 16)
            if len(buf) < i + 2 + size + 2:
                break
            payload += bytes(buf[i + 2:i + 2 + size])
            buf = buf[i + 2 + size + 2:]
        got, remainder = wire.split_frames(remainder + payload)
        frames.extend(got)
    assert len(frames) >= 3
    gens = [meta["generation"] for _, meta in frames]
    assert gens == sorted(gens)
    # the every=2 cadence: consecutive pushed frames are >= 2 gens apart
    for a, b in zip(gens, gens[1:]):
        assert b - a >= 2
    # each frame is a valid decoded grid of the session's geometry
    for grid, meta in frames:
        assert grid.shape == (32, 32)
    s.close()


def test_stream_on_threaded_answers_501(threaded):
    c = _conn(threaded)
    sid = _create(c, rows=16, cols=16, backend="serial", seed=8)
    status, err, _ = _roundtrip(c, "GET", f"/stream/{sid}")
    assert status == 501 and "--front aio" in err["error"]


def test_stream_unknown_session_404(aio):
    c = _conn(aio)
    status, err, _ = _roundtrip(c, "GET", "/stream/nope")
    assert status == 404


# ------------------------------------------------------- parked waiters


def test_parked_waiter_wakes_on_resolution(aio):
    c = _conn(aio)
    sid = _create(c, rows=16, cols=16, backend="serial", seed=9)
    mgr = aio.manager
    session = mgr.get(sid)
    parked = _park_signal(aio)

    # hold the session lock: the dispatch loop cannot commit, so the
    # ticket stays pending and the waiter must actually park
    session.lock.acquire()
    try:
        status, tk, _ = _roundtrip(c, "POST", f"/sessions/{sid}/step",
                                   {"steps": 1, "async": True})
        assert status == 200
        results = {}

        def wait():
            c2 = _conn(aio)
            results["resp"] = _roundtrip(
                c2, "GET", f"/result/{tk['ticket']}?wait=1")
            c2.close()

        waiter = threading.Thread(target=wait)
        waiter.start()
        assert parked.wait(timeout=10)
        assert aio.stats()["parked_waiters"] >= 1
        assert aio.stats()["parked_total"] >= 1
    finally:
        session.lock.release()
    waiter.join(timeout=10)
    assert not waiter.is_alive()
    status, result, _ = results["resp"]
    assert status == 200 and result["status"] == "done"
    assert result["result"]["generation"] >= 1


def test_parked_waiter_timeout_answers_pending(aio):
    c = _conn(aio)
    sid = _create(c, rows=16, cols=16, backend="serial", seed=10)
    session = aio.manager.get(sid)
    session.lock.acquire()
    try:
        status, tk, _ = _roundtrip(c, "POST", f"/sessions/{sid}/step",
                                   {"steps": 1, "async": True})
        assert status == 200
        t0 = time.monotonic()
        c2 = _conn(aio)
        status, result, _ = _roundtrip(
            c2, "GET", f"/result/{tk['ticket']}?wait=1&timeout_s=0.3")
        elapsed = time.monotonic() - t0
        # the wait budget expired: same "pending" payload the threaded
        # front's timed-out event.wait answers, and the socket was
        # parked (no worker thread burned) while it waited
        assert status == 200 and result["status"] == "pending"
        assert 0.2 <= elapsed < 5.0
        c2.close()
    finally:
        session.lock.release()


def test_wait_on_unknown_ticket_404(aio):
    c = _conn(aio)
    status, err, _ = _roundtrip(c, "GET", "/result/t999?wait=1")
    assert status == 404 and "ticket" in err["error"]


# ------------------------------------------------------- backpressure


def test_stream_drop_to_latest_backpressure():
    """Unit-level: a connection whose write buffer is over the bound
    must drop frames to a one-slot latest, and promote that slot when
    the socket drains — never an unbounded queue, never a stale frame
    when a fresher one exists."""
    srv = AioServer(port=0, manager=SessionManager(device="cpu"),
                    stream_buffer=64)
    try:
        a, b = socket.socketpair()
        a.setblocking(False)
        conn = _Conn(a)
        srv._conns[conn.fd] = conn
        conn.stream = {"sid": "sX", "every": 1, "last": None,
                       "dirty": False, "delta": False, "window": None,
                       "key_pending": False}
        conn.busy = True

        grid = np.ones((8, 8), dtype=np.uint8)
        f1 = wire.encode_frame(grid, generation=1)
        f2 = wire.encode_frame(grid, generation=2)
        f3 = wire.encode_frame(grid, generation=3)

        # saturated: over the bound -> both frames drop to the slot,
        # latest wins
        conn.wbuf += b"x" * (srv.stream_buffer + 1)
        srv._deliver_frame(conn, f1, 1)
        srv._deliver_frame(conn, f2, 2)
        assert srv.frames_dropped == 2
        assert conn.pending_frame is not None
        _, gen = conn.pending_frame
        assert gen == 2                 # drop-to-LATEST
        assert srv.frames_pushed == 0

        # drain: the slot is promoted exactly once
        del conn.wbuf[:]
        srv._flush(conn)
        assert conn.pending_frame is None
        assert conn.stream["last"] == 2
        assert srv.frames_pushed == 1
        drain = b.recv(65536)
        # strip the chunk framing the stream writes around each frame
        size_end = drain.find(b"\r\n")
        size = int(drain[:size_end], 16)
        frames, _rest = wire.split_frames(
            drain[size_end + 2:size_end + 2 + size])
        assert [m["generation"] for _, m in frames] == [2]

        # healthy buffer: frames flow straight through
        srv._deliver_frame(conn, f3, 3)
        assert srv.frames_pushed == 2 and conn.pending_frame is None
        b.close()
    finally:
        srv.server_close()
        srv.manager.shutdown()


def test_resolve_burst_drains_fifo_bounded_by_free_workers():
    """Unit-level: a ticket-resolve burst must not flood the worker pool
    — unparked waiters queue FIFO with at most ``workers`` of them on
    the pool at once, each finishing dispatch admits exactly the next
    one in park order, and a connection that died while queued is
    skipped rather than dispatched."""
    srv = AioServer(port=0, manager=SessionManager(device="cpu"), workers=2)
    socks = []
    try:
        submitted = []

        def fake_submit(conn, req):
            # what _submit does minus the pool: claim a worker slot
            conn.inflight = True
            srv._dispatching += 1
            submitted.append(req)

        srv._submit = fake_submit
        conns = []
        for i in range(5):
            a, b = socket.socketpair()
            a.setblocking(False)
            socks += [a, b]
            conn = _Conn(a)
            srv._conns[conn.fd] = conn
            info = {"tid": f"t{i}", "req": f"req{i}", "timer": None,
                    "fn": None}
            conn.parked = info
            conns.append((conn, info))

        # the burst: every waiter resolves at once
        for conn, info in conns:
            srv._unpark(conn, info)
        assert submitted == ["req0", "req1"]    # bounded by workers
        assert srv._dispatching == 2
        st = srv.stats()
        assert st["resolve_queue_depth"] == 3
        assert st["resolved_dispatched"] == 2

        # conn 3 dies while queued: skipped, never dispatched
        conns[3][0].closed = True

        # each freed worker admits exactly the NEXT waiter, FIFO
        srv._dispatching -= 1
        srv._drain_resolved()
        assert submitted == ["req0", "req1", "req2"]
        srv._dispatching -= 1
        srv._drain_resolved()
        assert submitted == ["req0", "req1", "req2", "req4"]
        assert srv.stats()["resolve_queue_depth"] == 0
        assert srv.stats()["resolved_dispatched"] == 4
    finally:
        for s in socks:
            s.close()
        srv.server_close()
        srv.manager.shutdown()


# --------------------------------------------------- step notifications


@pytest.mark.parametrize("backend", ["serial", "cuda"])
def test_step_listener_fires_on_all_commit_paths(backend):
    """Every commit path notifies: the solo step, the microbatch (cuda
    sessions coalesce), the async ticket chain, and board writes; each
    listener call comes after the commit, with the session's grid at the
    new generation."""
    mgr = SessionManager(device="cpu")
    try:
        seen = []
        mgr.add_step_listener(lambda s: seen.append((s.id, s.generation)))
        sid = mgr.create({"rows": 16, "cols": 16, "backend": backend,
                          "seed": 11})["id"]
        mgr.step(sid, 2)
        assert (sid, 2) in seen
        n = len(seen)
        tk = mgr.step_async(sid, 2)
        mgr.ticket_result(tk["ticket"], wait=True)
        assert len(seen) > n and seen[-1] == (sid, 4)
        n = len(seen)
        grid = np.zeros((16, 16), dtype=np.uint8)
        mgr.write_board(sid, grid)
        assert len(seen) > n
        n = len(seen)
        mgr.write_window(sid, 0, 0, np.ones((2, 2), dtype=np.uint8))
        assert len(seen) > n
        mgr.remove_step_listener(seen.append)   # unknown fn: a no-op
    finally:
        mgr.shutdown()
