"""The reference's HTTP scenarios against the port's network front on the
CPU: those of ``tests/test_serve.py``, ``test_serve_async.py``,
``test_serve_faults.py``, ``test_serve_durability.py``, ``test_obs.py``,
``test_slo.py`` and ``test_flight.py`` that go through a server, without
the cluster ones (gossip, failover, drain, the ``/slo`` roll-up: ROADMAP
queue 1 item 11c).  The server-subprocess SIGKILL restores are in
``tests/test_torch_serve_cli.py``.

Every server binds port 0 and runs over a ``SessionManager(device="cpu")``
(``backend: "cuda"`` sessions step the kernels' plain versions); the
``_served`` context shuts the server down, joins its thread and shuts the
manager down.  Boards are held to the reference's ``serial_np`` oracle.
"""

from __future__ import annotations

import contextlib
import http.client
import json
import os
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from obs_smoke import (  # noqa: E402
    check_histograms, check_trace, parse_prometheus,
)

from mpi_tpu.backends.serial_np import evolve_np  # noqa: E402
from mpi_tpu.models.rules import LIFE  # noqa: E402
from mpi_tpu.utils.hashinit import init_tile_np  # noqa: E402
from mpi_tpu_torch.obs import Obs  # noqa: E402
from mpi_tpu_torch.obs.metrics import FAMILIES  # noqa: E402
from mpi_tpu_torch.serve.cache import EngineCache  # noqa: E402
from mpi_tpu_torch.serve.httpd import make_server  # noqa: E402
from mpi_tpu_torch.serve.session import SessionManager  # noqa: E402

CUDA_SPEC = {"rows": 64, "cols": 64, "backend": "cuda"}


def _oracle(rows, cols, seed, steps, boundary="periodic", rule=LIFE):
    return evolve_np(init_tile_np(rows, cols, seed), steps, rule, boundary)


def _grid_of(snap):
    return np.array([[int(c) for c in row] for row in snap["grid"]],
                    dtype=np.uint8)


def _manager(*args, **kw):
    kw.setdefault("device", "cpu")
    if not args:
        args = (EngineCache(max_size=4),)
    return SessionManager(*args, **kw)


@contextlib.contextmanager
def _served(mgr, **kw):
    srv = make_server(port=0, manager=mgr, **kw)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield srv
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        mgr.shutdown()
        if mgr.obs is not None:
            mgr.obs.close()
        assert not thread.is_alive()


def _req(srv, method, path, body=None, headers=None, raw=False):
    """(status, JSON body or text, headers) of one request."""
    host, port = srv.server_address[:2]
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data,
                                 method=method)
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            payload = resp.read()
            return (resp.status,
                    payload.decode() if raw else json.loads(payload),
                    dict(resp.headers))
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _join_workers(mgr):
    """Wait for the watchdog workers a timed-out request abandoned."""
    for t in list(mgr._workers):
        t.join(timeout=30)
        assert not t.is_alive()


# ------------------------------------------------------- tests/test_serve.py


def test_http_round_trip():
    with _served(_manager()) as srv:
        status, health, _ = _req(srv, "GET", "/healthz")
        assert status == 200 and health["ok"]
        status, created, _ = _req(srv, "POST", "/sessions",
                                  {"rows": 48, "cols": 48,
                                   "backend": "serial", "seed": 9})
        assert status == 200
        sid = created["id"]
        status, stepped, _ = _req(srv, "POST", f"/sessions/{sid}/step",
                                  {"steps": 6})
        assert status == 200 and stepped["generation"] == 6
        status, snap, _ = _req(srv, "GET", f"/sessions/{sid}/snapshot")
        assert status == 200
        assert np.array_equal(_grid_of(snap), _oracle(48, 48, 9, 6))
        status, stats, _ = _req(srv, "GET", "/stats")
        assert status == 200
        assert stats["sessions"][0]["id"] == sid
        assert stats["sessions"][0]["generation"] == 6
        assert stats["sessions"][0]["throughput"]["gens_per_s"] > 0
        assert "hits" in stats["cache"]
        assert "batched" in stats["cache"]
        assert "coalesced_calls" in stats["batch"]
        status, closed, _ = _req(srv, "DELETE", f"/sessions/{sid}")
        assert status == 200 and closed["closed"]
        status, _, _ = _req(srv, "GET", f"/sessions/{sid}/density")
        assert status == 404


def test_http_errors():
    with _served(_manager()) as srv:
        assert _req(srv, "GET", "/nope")[0] == 404
        assert _req(srv, "POST", "/sessions", {"rows": 16})[0] == 400
        status, err, _ = _req(srv, "POST", "/sessions",
                              {"rows": 16, "cols": 16, "backend": "serial",
                               "typo_knob": 1})
        assert status == 400 and "typo_knob" in err["error"]
        _, created, _ = _req(srv, "POST", "/sessions",
                             {"rows": 16, "cols": 16, "backend": "serial"})
        assert _req(srv, "POST", f"/sessions/{created['id']}/step",
                    {"steps": "three"})[0] == 400


@pytest.mark.parametrize("obs", [False, True])
def test_unexpected_exception_is_structured_500(obs, tmp_path, monkeypatch):
    """A bug in a handler answers structured JSON with a request id, never
    an HTML traceback page; with obs on, the ring is dumped to the
    reference's crash-dump file name in the temp dir."""
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", None)
    mgr = _manager(obs=Obs() if obs else None)
    if obs:
        mgr.obs.arm_flight(manager=mgr)
    with _served(mgr) as srv:
        mgr.stats = lambda: 1 / 0                # simulated internal bug
        status, body, headers = _req(srv, "GET", "/stats")
        assert status == 500
        assert headers.get("Content-Type") == "application/json"
        assert "internal server error" in body["error"]
        assert isinstance(body["request_id"], int)
        if obs:
            assert len(body["trace_id"]) == 32
            want = os.path.join(str(tmp_path),
                                f"mpi_tpu_trace_crash_{os.getpid()}.jsonl")
            assert body["trace_dump"] == want
            recs = [json.loads(ln) for ln in open(want)]
            assert any(r["name"] == "crash_dump" for r in recs)
            assert body["flight_dump"] == want + ".flights.jsonl"
            assert os.path.exists(body["flight_dump"])
        else:
            assert "trace_dump" not in body
        assert _req(srv, "GET", "/healthz")[0] == 200


# ------------------------------------------------ tests/test_serve_async.py


def test_http_async_roundtrip():
    with _served(_manager(EngineCache(max_size=4))) as srv:
        _, created, _ = _req(srv, "POST", "/sessions",
                             dict(CUDA_SPEC, seed=101))
        sid = created["id"]
        code, t, _ = _req(srv, "POST", f"/sessions/{sid}/step?async=1",
                          {"steps": 4})
        assert code == 200 and t["status"] == "pending" and "ticket" in t
        code, out, _ = _req(srv, "GET", f"/result/{t['ticket']}?wait=1")
        assert code == 200 and out["status"] == "done"
        assert out["result"]["generation"] == 4
        code, t2, _ = _req(srv, "POST", f"/sessions/{sid}/step",
                           {"steps": 1, "async": True})
        assert code == 200 and t2["status"] == "pending"
        code, out2, _ = _req(srv, "GET", f"/result/{t2['ticket']}?wait=1")
        assert code == 200 and out2["result"]["generation"] == 5
        code, snap, _ = _req(srv, "GET", f"/sessions/{sid}/snapshot")
        assert np.array_equal(_grid_of(snap), _oracle(64, 64, 101, 5))
        _, stats, _ = _req(srv, "GET", "/stats")
        assert stats["async"]["tickets_completed"] == 2
        sess = [s for s in stats["sessions"] if s["id"] == sid][0]
        assert sess["tickets_completed"] == 2
        assert {"queue_depth", "tickets_pending"} <= set(sess)
        code, _, _ = _req(srv, "GET", "/result/t999")
        assert code == 404


def test_http_expired_ticket_is_same_structured_503():
    """A ticket that hits its deadline answers the structured 503 the
    blocking path uses: {"error": ..., "request_id": ...}."""
    mgr = _manager()
    with _served(mgr) as srv:
        _, created, _ = _req(srv, "POST", "/sessions",
                             {"rows": 32, "cols": 32, "backend": "serial",
                              "seed": 5})
        sid = created["id"]
        session = mgr.get(sid)
        # the session lock held: the first ticket cannot commit, and the
        # second expires in the queue behind it
        session.lock.acquire()
        try:
            code, slow, _ = _req(srv, "POST",
                                 f"/sessions/{sid}/step?async=1",
                                 {"steps": 400})
            assert code == 200
            code, doomed, _ = _req(
                srv, "POST", f"/sessions/{sid}/step?async=1&timeout_s=0.001",
                {"steps": 1})
            assert code == 200
        finally:
            session.lock.release()
        code, body, _ = _req(srv, "GET", f"/result/{doomed['ticket']}?wait=1")
        assert code == 503
        assert "error" in body and "request_id" in body
        assert "budget" in body["error"]
        code, out, _ = _req(srv, "GET", f"/result/{slow['ticket']}?wait=1")
        assert code == 200 and out["result"]["generation"] == 400


def test_http_async_disabled_is_400():
    with _served(_manager(async_enabled=False)) as srv:
        _, created, _ = _req(srv, "POST", "/sessions",
                             {"rows": 16, "cols": 16, "backend": "serial"})
        code, body, _ = _req(srv, "POST",
                             f"/sessions/{created['id']}/step?async=1",
                             {"steps": 1})
        assert code == 400 and "async" in body["error"]
        code, _, _ = _req(srv, "GET", "/result/t1")
        assert code == 404
        code, r, _ = _req(srv, "POST", f"/sessions/{created['id']}/step",
                          {"steps": 2})
        assert code == 200 and r["generation"] == 2


def test_http_queue_full_is_503_with_retry_after():
    """The async queue's bound answers the structured 503 with a
    ``Retry-After`` of one second."""
    mgr = _manager(async_queue_max=1)
    with _served(mgr) as srv:
        _, created, _ = _req(srv, "POST", "/sessions",
                             {"rows": 16, "cols": 16, "backend": "serial"})
        sid = created["id"]
        session = mgr.get(sid)
        session.lock.acquire()
        try:
            codes = [_req(srv, "POST", f"/sessions/{sid}/step?async=1",
                          {"steps": 1}) for _ in range(3)]
        finally:
            session.lock.release()
        full = [c for c in codes if c[0] == 503]
        assert full and all(c[2].get("Retry-After") == "1" for c in full)
        assert all("request_id" in c[1] for c in full)


def test_reset_stats_zeroes_counters_and_keeps_tickets():
    """The batcher's and the dispatcher's ``reset_stats`` zero their
    throughput counters (a clean window after warm-ups); resolved tickets
    stay resolvable."""
    mgr = _manager(batch_window_ms=50.0)
    try:
        sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in (1, 2)]
        threads = [threading.Thread(target=mgr.step, args=(s, 2))
                   for s in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        tid = mgr.step_async(sids[0], 3)["ticket"]
        assert mgr.ticket_result(tid, wait=True)["status"] == "done"
        before = mgr.batcher.stats()
        assert before["coalesced_calls"] + before["solo_steps"] >= 1
        assert mgr.dispatcher.stats()["unit_rounds"] >= 1
        mgr.batcher.reset_stats()
        mgr.dispatcher.reset_stats()
        b, d = mgr.batcher.stats(), mgr.dispatcher.stats()
        assert (b["coalesced_calls"], b["batched_boards"], b["solo_steps"],
                b["max_occupancy"], b["batched_fallbacks"]) == (0,) * 5
        assert b["batched_step_s"] == 0.0 and b["solo_step_s"] == 0.0
        assert (d["group_dispatches"], d["unit_rounds"], d["board_rounds"],
                d["max_occupancy"], d["solo_tickets"],
                d["batched_fallbacks"]) == (0,) * 6
        assert mgr.ticket_result(tid)["result"]["generation"] == 5
    finally:
        mgr.shutdown()


# ------------------------------------------------ tests/test_serve_faults.py


def test_http_fault_outcomes_and_deep_healthz():
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = _manager(cache, step_retries=1, retry_backoff_s=0.001,
                   faults="step:1-2:raise")
    with _served(mgr) as srv:
        code, created, _ = _req(srv, "POST", "/sessions",
                                dict(CUDA_SPEC, seed=61))
        assert code == 200
        sid = created["id"]
        code, r, _ = _req(srv, "POST", f"/sessions/{sid}/step", {"steps": 1})
        assert code == 200 and r["generation"] == 1     # degraded, served
        code, h, _ = _req(srv, "GET", "/healthz")
        assert code == 200 and h["degraded_sessions"] == 1
        assert len(h["breaker"]["open"]) == 1 and h["breaker"]["trips"] == 1
        assert h["faults_injected"] == 2
        assert h["last_dispatch_ok_age_s"] is None
        code, st, _ = _req(srv, "GET", "/stats")
        assert code == 200 and st["failures"]["degraded_sessions"] == 1


def test_http_healthz_503_when_degraded_without_fallback():
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = _manager(cache, step_retries=3, retry_backoff_s=0.001,
                   degrade=False, faults="step:1-2:raise")
    with _served(mgr) as srv:
        code, created, _ = _req(srv, "POST", "/sessions",
                                dict(CUDA_SPEC, seed=63))
        sid = created["id"]
        code, body, _ = _req(srv, "POST", f"/sessions/{sid}/step",
                             {"steps": 1})
        assert code == 503 and "breaker" in body["error"]
        assert "request_id" in body
        code, h, _ = _req(srv, "GET", "/healthz")
        assert code == 503 and h["ok"] is False


def test_http_timeout_query_param():
    mgr = _manager(EngineCache(max_size=4), step_retries=0,
                   faults="step:1:hang:1.0")
    with _served(mgr) as srv:
        code, created, _ = _req(srv, "POST", "/sessions",
                                dict(CUDA_SPEC, seed=67))
        sid = created["id"]
        code, body, _ = _req(srv, "POST",
                             f"/sessions/{sid}/step?timeout_s=0.2",
                             {"steps": 1})
        assert code == 503 and "budget" in body["error"]
        code, body, _ = _req(srv, "POST",
                             f"/sessions/{sid}/step?timeout_s=oops",
                             {"steps": 1})
        assert code == 400
        _join_workers(mgr)              # the abandoned worker drains
        code, r, _ = _req(srv, "POST", f"/sessions/{sid}/step", {"steps": 1})
        assert code == 200 and r["generation"] == 1


# -------------------------------------------- tests/test_serve_durability.py


def test_transport_maps_degraded_to_structured_503(tmp_path):
    """Storage failures answer a structured 503 with ``persistence:
    degraded`` and a ``Retry-After`` sized to the persistence backoff;
    /healthz carries the persistence block."""
    mgr = _manager(EngineCache(max_size=2), state_dir=str(tmp_path),
                   checkpoint_every=1, state_degrade="shed",
                   faults="io-write:2-99:raise")
    sid = mgr.create({"rows": 16, "cols": 16, "backend": "serial",
                      "seed": 4})["id"]
    mgr.step(sid, 1)                    # -> degraded
    with _served(mgr) as srv:
        code, body, headers = _req(srv, "POST", f"/sessions/{sid}/step",
                                   {"steps": 1})
        assert code == 503
        assert body["persistence"] == "degraded"
        assert "error" in body and "request_id" in body
        ra = headers.get("Retry-After")
        assert ra is not None and ra.isdigit() and int(ra) >= 1
        code, h, _ = _req(srv, "GET", "/healthz")
        assert code == 503 and h["ok"] is False
        assert h["persistence"]["state"] == "degraded"


# ----------------------------------------------------- tests/test_obs.py


@pytest.fixture()
def obs_server(tmp_path):
    trace_log = tmp_path / "trace.jsonl"
    obs = Obs(trace_log=str(trace_log))
    mgr = _manager(EngineCache(max_size=4), obs=obs)
    with _served(mgr, profile_dir=str(tmp_path / "prof")) as srv:
        yield srv, obs, trace_log


def test_metrics_endpoint_and_trace_linkage(obs_server):
    srv, obs, trace_log = obs_server
    _, created, _ = _req(srv, "POST", "/sessions", dict(CUDA_SPEC))
    sid = created["id"]
    for _ in range(2):
        _req(srv, "POST", f"/sessions/{sid}/step", {"steps": 1})
    status, text, headers = _req(srv, "GET", "/metrics", raw=True)
    assert status == 200
    assert headers["Content-Type"] == \
        "text/plain; version=0.0.4; charset=utf-8"
    types, samples = parse_prometheus(text)
    missing = [m for m in FAMILIES["core"] if m not in types]
    assert not missing, f"/metrics missing families: {missing}"
    check_histograms(types, samples)
    vals = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}
    assert vals[("mpi_tpu_http_requests_total",
                 (("code", "200"), ("method", "POST")))] >= 2
    _, stats, _ = _req(srv, "GET", "/stats")
    assert stats["obs"]["trace"]["recorded"] > 0
    assert stats["obs"]["breakdown"]["regime"] in (
        "idle", "compile-bound", "dispatch-bound", "compute-bound")
    # the negotiated OpenMetrics upgrade
    status, om, headers = _req(
        srv, "GET", "/metrics", raw=True,
        headers={"Accept": "application/openmetrics-text"})
    assert status == 200
    assert headers["Content-Type"].startswith("application/openmetrics-text")
    obs.close()     # flush the stream before reading it back
    n_recs, n_linked = check_trace(str(trace_log))
    assert n_recs > 0 and n_linked >= 2


def test_debug_trace_endpoint_stitches_local_tree(obs_server):
    """An incoming traceparent is continued, and ``GET
    /debug/trace/<id>`` answers the stitched single-node tree."""
    srv, _, _ = obs_server
    _, created, _ = _req(srv, "POST", "/sessions", dict(CUDA_SPEC))
    sid = created["id"]
    want_tid, want_span = "ab" * 16, "cd" * 8
    status, _, headers = _req(
        srv, "POST", f"/sessions/{sid}/step", {"steps": 1},
        headers={"X-Gol-Traceparent": f"00-{want_tid}-{want_span}-01"})
    assert status == 200
    assert want_tid in headers.get("X-Gol-Traceparent", "")
    status, doc, _ = _req(srv, "GET", f"/debug/trace/{want_tid}")
    assert status == 200
    assert doc["complete"] and not doc["partial"]
    assert doc["nodes"] == ["local"]
    reqs = [s for s in doc["spans"] if s["name"] == "http_request"]
    assert reqs and reqs[0]["parent_span_id"] == want_span
    req_node = next(n for n in doc["tree"] if n["name"] == "http_request")
    assert req_node["children"]


def test_watchdog_timeout_503_carries_trace_and_request_ids():
    mgr = _manager(EngineCache(max_size=4), obs=Obs(),
                   request_timeout_s=0.3, step_retries=0,
                   faults="step:1:hang:1.0")
    with _served(mgr) as srv:
        _, created, _ = _req(srv, "POST", "/sessions",
                             dict(CUDA_SPEC, seed=53))
        sid = created["id"]
        status, body, headers = _req(srv, "POST", f"/sessions/{sid}/step",
                                     {"steps": 1})
        assert status == 503
        assert "request_id" in body
        tid = body.get("trace_id")
        assert tid and len(tid) == 32
        assert tid in headers.get("X-Gol-Traceparent", "")
        assert mgr.watchdog_timeouts == 1
        _join_workers(mgr)


def test_metrics_404_when_obs_disabled():
    with _served(_manager(EngineCache(max_size=4), obs=None)) as srv:
        for path in ("/metrics", f"/debug/trace/{'ab' * 16}", "/usage",
                     "/slo", "/debug/timeseries", "/debug/flights",
                     "/debug/anomalies"):
            status, body, _ = _req(srv, "GET", path)
            assert status == 404 and "--no-obs" in body["error"], path


def test_profile_endpoint(obs_server, tmp_path):
    """``POST /debug/profile`` runs the port's ``torch.profiler`` capture
    and answers where it wrote the Chrome trace."""
    srv, _, _ = obs_server
    status, body, _ = _req(srv, "POST", "/debug/profile?secs=0.05")
    assert status == 200 and body["ok"], body
    assert os.path.dirname(body["path"]) == str(tmp_path / "prof")
    with open(body["path"]) as fh:
        assert "traceEvents" in json.load(fh)
    status, body, _ = _req(srv, "POST", "/debug/profile?secs=nope")
    assert status == 400


def test_profile_404_when_unarmed():
    with _served(_manager(EngineCache(max_size=4), obs=Obs())) as srv:
        status, body, _ = _req(srv, "POST", "/debug/profile")
        assert status == 404 and "--profile-dir" in body["error"]


# ----------------------------------------------------- tests/test_slo.py


def _force_critical(obs):
    obs.telemetry.sample_once()
    obs.http_requests.inc(30, method="POST", path="/step", code="500")
    obs.telemetry.sample_once()
    assert obs.slo.worst() == "critical"


def test_unarmed_endpoints_404_and_healthz_has_no_slo_block():
    with _served(_manager(batching=False, obs=Obs())) as srv:
        for path in ("/slo", "/debug/timeseries"):
            st, err, _ = _req(srv, "GET", path)
            assert st == 404 and "--telemetry-interval-s" in err["error"]
        st, h, _ = _req(srv, "GET", "/healthz")
        assert st == 200 and "slo" not in h


def test_armed_endpoints_and_critical_slo_never_flips_healthz_ok():
    obs = Obs()
    mgr = _manager(batching=False, obs=obs)
    obs.arm_telemetry(interval_s=5.0, manager=mgr, start=False)
    with _served(mgr) as srv:
        _force_critical(obs)
        st, doc, _ = _req(srv, "GET", "/slo")
        assert st == 200 and doc["worst"] == "critical"
        assert "cluster" not in doc
        st, ts, _ = _req(srv, "GET", "/debug/timeseries")
        assert st == 200 and "http_requests" in ts["series"]
        st, ts, _ = _req(srv, "GET",
                         "/debug/timeseries?series=http_requests&window=1m")
        assert st == 200 and ts["kind"] == "counter"
        stamps = [t for t, _ in ts["points"]]
        assert stamps == sorted(stamps)
        st, _err, _ = _req(srv, "GET", "/debug/timeseries?window=2d")
        assert st == 400
        st, err, _ = _req(srv, "GET", "/debug/timeseries?series=nope")
        assert st == 404 and "no series" in err["error"]
        st, h, _ = _req(srv, "GET", "/healthz")
        assert st == 200 and h["ok"] is True
        assert h["slo"]["worst"] == "critical"
        assert h["slo"]["burning"] == ["availability"]


# ---------------------------------------------------- tests/test_flight.py


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


def test_unarmed_server_records_nothing_and_404s():
    obs = Obs()
    with _served(_manager(EngineCache(max_size=2), obs=obs,
                          batching=False)) as srv:
        st, body, _ = _req(srv, "POST", "/sessions",
                           {"rows": 16, "cols": 16, "backend": "cuda"})
        assert st == 200
        sid = body["id"]
        st, _, _ = _req(srv, "POST", f"/sessions/{sid}/step", {"steps": 2})
        assert st == 200
        assert obs.flight is None and obs.anomaly is None
        st, text, _ = _req(srv, "GET", "/metrics", raw=True)
        for fam in FAMILIES["flight"] + FAMILIES["slo"] \
                + FAMILIES["admission"]:
            assert fam not in text
        kinds = {r["name"] for r in obs.tracer.snapshot()}
        assert not kinds & {"flight_drop", "dispatch_anomaly"}
        st, body, _ = _req(srv, "GET", "/debug/flights")
        assert st == 404 and "--flight-recorder" in body["error"]
        st, body, _ = _req(srv, "GET", "/debug/anomalies")
        assert st == 404 and "--anomaly-detect" in body["error"]


def test_no_obs_server_404s_both_debug_endpoints():
    mgr = _manager(EngineCache(max_size=2), obs=None, batching=False)
    with _served(mgr) as srv:
        info = mgr.create({"rows": 16, "cols": 16, "backend": "cuda"})
        mgr.step(info["id"], 1)
        for path in ("/debug/flights", "/debug/anomalies"):
            st, body, _ = _req(srv, "GET", path)
            assert st == 404 and "--no-obs" in body["error"]


def test_armed_endpoint_filters_and_errors():
    obs = Obs()
    mgr = _manager(EngineCache(max_size=2), obs=obs, batching=False)
    obs.arm_flight(capacity=8, manager=mgr, anomaly=True)
    with _served(mgr) as srv:
        info = mgr.create({"rows": 16, "cols": 16, "backend": "cuda"})
        for _ in range(3):
            mgr.step(info["id"], 1)
        st, doc, _ = _req(srv, "GET", "/debug/flights")
        assert st == 200 and doc["count"] == 3
        assert all(r["session"] == info["id"] and r["kernel"] == "K1"
                   for r in doc["flights"])
        assert _req(srv, "GET", "/debug/flights?limit=1")[1]["count"] == 1
        assert _req(srv, "GET",
                    f"/debug/flights?session={info['id']}")[1]["count"] == 3
        assert _req(srv, "GET",
                    "/debug/flights?session=nope")[1]["count"] == 0
        assert _req(srv, "GET", "/debug/flights?slower_than=abc")[0] == 400
        assert _req(srv, "GET", "/debug/flights?limit=x")[0] == 400
        st, doc, _ = _req(srv, "GET", "/debug/anomalies")
        assert st == 200
        assert doc["windows_s"] == {"1m": 60.0, "5m": 300.0}
        assert doc["capture"]["profile_dir"] is None


def test_e2e_latency_regression_rings_and_captures(tmp_path):
    """A served session's steps slow down mid-stream (``step:41+:delay``):
    the detector rings one ``dispatch_anomaly`` with exemplar trace ids,
    arms exactly one capture, and ``/debug/flights`` attributes the slow
    steps.  The injected delay (0.2 s) and the ``slower_than`` filter
    (0.1 s) leave a wide margin over an undelayed 16x16 step on the CPU."""
    obs = Obs()
    clock = _FakeClock(5000.0)
    caps = []
    mgr = _manager(EngineCache(max_size=2), obs=obs, batching=False,
                   faults="step:41+:delay:0.2")
    tel = obs.arm_telemetry(interval_s=5.0, manager=mgr, clock=clock,
                            start=False)
    obs.arm_flight(capacity=64, manager=mgr, anomaly=True,
                   profile_dir=str(tmp_path), devmem=False, clock=clock,
                   capture_fn=lambda d, s: caps.append(d))
    with _served(mgr) as srv:
        st, body, _ = _req(srv, "POST", "/sessions",
                           {"rows": 16, "cols": 16, "backend": "cuda"})
        assert st == 200
        sid = body["id"]
        for _ in range(40):
            clock.t += 9.0
            assert _req(srv, "POST", f"/sessions/{sid}/step",
                        {"steps": 1})[0] == 200
        clock.t += 301.0
        for _ in range(16):
            clock.t += 1.0
            assert _req(srv, "POST", f"/sessions/{sid}/step",
                        {"steps": 1})[0] == 200
        tel.sample_once(clock.t)
        events = [r for r in obs.tracer.snapshot()
                  if r["name"] == "dispatch_anomaly"]
        assert len(events) == 1
        ev = events[0]
        assert ev["direction"] == "slow"
        assert ev["ratios"]["1m"] >= 2.0 and ev["ratios"]["5m"] >= 2.0
        assert 1 <= len(ev["exemplars"]) <= 3
        assert all(len(t) == 32 for t in ev["exemplars"])
        assert len(caps) == 1 and ev["capture"] == caps[0]
        clock.t += 5.0
        tel.sample_once(clock.t)
        assert len([r for r in obs.tracer.snapshot()
                    if r["name"] == "dispatch_anomaly"]) == 1
        assert len(caps) == 1
        st, doc, _ = _req(srv, "GET", "/debug/flights?slower_than=0.1")
        assert doc["count"] == 16
        assert all(r["session"] == sid and r["device_s"] > 0.1
                   and r["trace_id"] for r in doc["flights"])
        assert set(ev["exemplars"]) <= {r["trace_id"] for r in doc["flights"]}
        st, doc, _ = _req(srv, "GET", "/debug/anomalies")
        assert doc["anomalies_total"] == {"slow": 1}
        assert doc["capture"]["captures"] == 1
        sigrows = {s["sig"]: s for s in doc["signatures"]}
        sig = doc["episodes"][0]["sig"]
        assert sigrows[sig]["state"] == "slow"
        st, text, _ = _req(srv, "GET", "/metrics", raw=True)
        assert f'mpi_tpu_anomaly_state{{sig="{sig}"}} 2' in text
        assert 'mpi_tpu_dispatch_anomalies_total{direction="slow"} 1' in text
        assert "mpi_tpu_anomaly_captures_total 1" in text


# ----------------------------------------- the aio front's metric families


def test_aio_front_registers_the_references_aio_families():
    from mpi_tpu_torch.serve.aio import make_aio_server

    obs = Obs()
    mgr = _manager(obs=obs)
    srv = make_aio_server(port=0, manager=mgr)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection(*srv.server_address[:2],
                                          timeout=30)
        conn.request("GET", "/metrics")
        text = conn.getresponse().read().decode()
        conn.close()
        types, _samples = parse_prometheus(text)
        for fam in FAMILIES["aio"] + FAMILIES["core"]:
            assert fam in types, fam
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        mgr.shutdown()
    assert not thread.is_alive()
