"""HTTP parity: the port's network front beside the reference's.

The reference's ``make_server``/``make_aio_server`` over its own manager
(``backend: "tpu"`` on a 1x1 JAX CPU mesh) and the port's over
``SessionManager(device="cpu")`` (``backend: "cuda"``, the kernels' plain
versions) are started side by side, both with a full ``Obs`` (telemetry
and the flight recorder armed at injected clocks, never started) and
admission armed with the same tenants file.  The same scripted requests
go to both, in the same order, so session ids, ticket ids and request ids
agree.  For every request the test holds:

* status codes, content types and ``Retry-After`` equal;
* binary ``application/x-gol-grid`` frames equal byte for byte;
* JSON bodies equal apart from the fields it names in ``MEASURED``
  (times, and what follows from them), ``trace_id`` (minted at random per
  request), the backend's name (``tpu`` against ``cuda``) and the backend
  part of the signature label (``/tpu/`` against ``/cuda/``);
* ``/metrics``: every family equal in name, type, help string and label
  names, and the port's list of the reference's families
  (``mpi_tpu_torch.obs.metrics.FAMILIES``) equal to the reference's own
  extraction (``mpi_tpu/analysis/obsreg.py``), so the list cannot go
  stale.

Admission decisions are compared with a cells-only quota (the tenant
``capped``): the device-seconds estimate is the port's own (K1-K3's cost
cards over the card's roof), the cells estimate is exact on both sides.
The rejected step asks for more than the whole window, so both answer a
full window in ``Retry-After``.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from obs_smoke import parse_prometheus  # noqa: E402

from mpi_tpu.admission import AdmissionControl as JaxAdmission  # noqa: E402
from mpi_tpu.admission.tenants import (  # noqa: E402
    normalize_tenants as jax_normalize_tenants,
)
from mpi_tpu.analysis.obsreg import (  # noqa: E402
    admission_families, flight_families, required_families, slo_families,
)
from mpi_tpu.obs import Obs as JaxObs  # noqa: E402
from mpi_tpu.serve.aio import make_aio_server as jax_make_aio  # noqa: E402
from mpi_tpu.serve.cache import EngineCache as JaxEngineCache  # noqa: E402
from mpi_tpu.serve.httpd import make_server as jax_make_server  # noqa: E402
from mpi_tpu.serve.session import SessionManager as JaxManager  # noqa: E402
from mpi_tpu_torch.admission import AdmissionControl  # noqa: E402
from mpi_tpu_torch.admission.tenants import normalize_tenants  # noqa: E402
from mpi_tpu_torch.obs import Obs  # noqa: E402
from mpi_tpu_torch.obs.metrics import FAMILIES  # noqa: E402
from mpi_tpu_torch.serve import wire  # noqa: E402
from mpi_tpu_torch.serve.aio import make_aio_server  # noqa: E402
from mpi_tpu_torch.serve.cache import EngineCache  # noqa: E402
from mpi_tpu_torch.serve.httpd import make_server  # noqa: E402
from mpi_tpu_torch.serve.session import SessionManager  # noqa: E402

GRID = wire.GRID_MEDIA_TYPE
TENANTS = [{"name": "capped", "cells_per_window": 64 * 64 * 10}]

# measured values (and what follows from them), compared by presence only
MEASURED = {
    "device_s", "host_s", "flops", "window_ms", "batched_step_s",
    "solo_step_s", "amortized_board_step_s", "compile_wall_s",
    "execute_wall_s", "solo_avg_call_s", "regime", "setup_s", "steady_s",
    "cell_updates_per_s", "last_dispatch_ok_age_s", "cost_cards",
    "roofline", "devices", "t_unix", "age_s", "value", "burn", "p50",
    "p90", "p95", "p99", "p999", "max", "mean", "sum", "burn_fast",
    "burn_slow", "oldest_s", "observed", "tail_ratio", "gens_per_s",
    "points", "t", "wall_s", "block_s", "dur_s", "ts", "t_mono",
    "trace_id", "span_id", "links", "baseline_p50",
}
# fields the port adds to a reply of the reference's shape: a flight
# record names the kernel that ran (K1-K3; the reference has no kernel ids)
PORT_ONLY = {"kernel"}


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _scrub(x, drop=()):
    if isinstance(x, dict):
        return {k: ("<measured>" if k in MEASURED else _scrub(v, drop))
                for k, v in x.items() if k not in drop}
    if isinstance(x, list):
        return [_scrub(v, drop) for v in x]
    if isinstance(x, str):
        # the backend's name, and the backend part of a signature label
        return "cuda" if x == "tpu" else x.replace("/tpu/", "/cuda/")
    return x


def _rows(grid):
    return ["".join(str(int(v)) for v in row) for row in grid]


def _world(rows, cols, seed):
    return np.random.default_rng(seed).integers(
        0, 2, size=(rows, cols)).astype(np.uint8)


def _script(backend):
    """(label, method, path, body, headers) in order; ``backend`` is the
    side's name for the card engine (``tpu`` or ``cuda``)."""
    life = {"rows": 64, "cols": 64, "backend": backend, "mesh": "1x1",
            "seed": 5}
    tenant = {"X-Gol-Tenant": "capped"}
    w2 = _world(32, 32, 7)
    frame = wire.encode_frame(_world(32, 32, 8), generation=21)
    patch = _world(4, 6, 9)
    return [
        ("healthz", "GET", "/healthz", None, {}),
        ("create-life", "POST", "/sessions", life, {}),
        ("create-serial", "POST", "/sessions",
         {"rows": 32, "cols": 32, "backend": "serial", "seed": 3}, {}),
        ("create-capped", "POST", "/sessions",
         dict(life, seed=6), tenant),
        ("step", "POST", "/sessions/s1/step", {"steps": 3}, {}),
        ("snapshot-json", "GET", "/sessions/s1/snapshot", None, {}),
        ("snapshot-binary", "GET", "/sessions/s1/snapshot", None,
         {"Accept": GRID}),
        ("viewport-json", "GET", "/sessions/s1/snapshot?x0=5&y0=60&h=8&w=10",
         None, {}),
        ("viewport-binary", "GET", "/sessions/s1/board?x0=60&y0=2&h=9&w=7",
         None, {"Accept": GRID}),
        ("write-json", "PUT", "/sessions/s2/board",
         {"grid": _rows(w2), "generation": 10}, {}),
        ("after-write-json", "GET", "/sessions/s2/snapshot", None,
         {"Accept": GRID}),
        ("write-binary", "PUT", "/sessions/s2/board", frame,
         {"Content-Type": GRID}),
        ("write-window", "PUT", "/sessions/s1/board",
         {"grid": _rows(patch), "x0": 2, "y0": 3}, {}),
        ("write-window-binary", "PUT", "/sessions/s1/board",
         wire.encode_window_frame(patch, x0=62, y0=61, board_shape=(64, 64)),
         {"Content-Type": GRID}),
        ("step-after-write", "POST", "/sessions/s2/step", {"steps": 2}, {}),
        ("after-write-binary", "GET", "/sessions/s2/snapshot", None,
         {"Accept": GRID}),
        ("async", "POST", "/sessions/s1/step?async=1", {"steps": 2}, {}),
        ("result-wait", "GET", "/result/t1?wait=1", None, {}),
        ("result-binary", "GET", "/result/t1", None, {"Accept": GRID}),
        ("async-body", "POST", "/sessions/s1/step",
         {"steps": 1, "async": True}, {}),
        ("result-wait-2", "GET", "/result/t2?wait=1&timeout_s=60", None, {}),
        ("result-nowait", "GET", "/result/t2", None, {}),
        ("density", "GET", "/sessions/s1/density", None, {}),
        ("capped-step", "POST", "/sessions/s3/step", {"steps": 1}, tenant),
        ("capped-over", "POST", "/sessions/s3/step", {"steps": 20}, tenant),
        ("capped-wrong-tenant", "POST", "/sessions/s3/step", {"steps": 1},
         {"X-Gol-Tenant": "default"}),
        ("unknown-tenant", "POST", "/sessions",
         {"rows": 8, "cols": 8, "backend": "serial"},
         {"X-Gol-Tenant": "ghost"}),
        ("bad-json", "POST", "/sessions", b"{not json", {}),
        ("body-not-object", "POST", "/sessions", b"[1, 2]", {}),
        ("unknown-session", "GET", "/sessions/nope/snapshot", None, {}),
        ("unknown-ticket", "GET", "/result/t999", None, {}),
        ("unknown-route", "GET", "/nowhere", None, {}),
        ("bad-timeout", "GET", "/sessions/s1/snapshot?timeout_s=abc", None,
         {}),
        ("bad-timeout-body", "POST", "/sessions/s1/step",
         {"steps": 1, "timeout_s": "soon"}, {}),
        ("bad-steps", "POST", "/sessions/s1/step", {"steps": "x"}, {}),
        ("partial-viewport", "GET", "/sessions/s1/snapshot?x0=1&y0=2", None,
         {}),
        ("bad-frame", "PUT", "/sessions/s1/board", b"not a frame at all..",
         {"Content-Type": GRID}),
        ("write-no-grid", "PUT", "/sessions/s1/board", {"generation": 3}, {}),
        ("stream", "GET", "/stream/nope", None, {}),
        ("bad-spec", "POST", "/sessions", {"rows": 8, "cols": 8,
                                           "backend": "serial",
                                           "bogus": 1}, {}),
        ("close", "DELETE", "/sessions/s2", None, {}),
        ("closed", "GET", "/sessions/s2/density", None, {}),
        ("usage", "GET", "/usage", None, {}),
        ("timeseries", "GET", "/debug/timeseries", None, {}),
        ("timeseries-series", "GET",
         "/debug/timeseries?series=sessions&window=5m", None, {}),
        ("timeseries-bad", "GET", "/debug/timeseries?window=1y", None, {}),
        ("flights", "GET", "/debug/flights?session=s1&limit=3", None, {}),
        ("flights-bad", "GET", "/debug/flights?slower_than=x", None, {}),
        ("anomalies", "GET", "/debug/anomalies", None, {}),
        ("profile-unarmed", "POST", "/debug/profile?secs=0.1", None, {}),
        ("healthz-end", "GET", "/healthz", None, {}),
        ("metrics", "GET", "/metrics", None, {}),
    ]


LABELS = [step[0] for step in _script("cuda")]


def _send(conn, method, path, body, headers):
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    conn.request(method, path, body=data, headers=dict(headers))
    resp = conn.getresponse()
    raw = resp.read()
    return (resp.status, resp.getheader("Content-Type"),
            resp.getheader("Retry-After"), raw)


def _run_side(side, front):
    """Serve the script from one side's server; returns {label: reply}.
    The server is shut down, its thread joined and (on the port) its
    manager shut down before this returns."""
    if side == "ref":
        obs = JaxObs()
        mgr = JaxManager(JaxEngineCache(max_size=4), obs=obs)
        adm = JaxAdmission(jax_normalize_tenants(TENANTS))
        mk = jax_make_aio if front == "aio" else jax_make_server
        backend = "tpu"
    else:
        obs = Obs()
        mgr = SessionManager(EngineCache(max_size=4), obs=obs, device="cpu")
        adm = AdmissionControl(normalize_tenants(TENANTS))
        mk = make_aio_server if front == "aio" else make_server
        backend = "cuda"
    clock = _Clock()
    obs.arm_telemetry(manager=mgr, clock=clock, start=False)
    obs.arm_flight(manager=mgr, anomaly=True, clock=clock)
    adm.arm(mgr, obs)
    srv = mk(port=0, manager=mgr)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        conn = http.client.HTTPConnection(*srv.server_address[:2],
                                          timeout=120)
        for label, method, path, body, headers in _script(backend):
            if label == "usage":
                obs.telemetry.sample_once()
                clock.t += 5.0
                obs.telemetry.sample_once()
            out[label] = _send(conn, method, path, body, headers)
        conn.close()
        # the body bound: a Content-Length over 64 MiB answers a
        # structured 413 before any body byte, and closes
        big = http.client.HTTPConnection(*srv.server_address[:2], timeout=30)
        big.request("POST", "/sessions", body=b"",
                    headers={"Content-Length": str(1 << 30)})
        resp = big.getresponse()
        out["oversized"] = (resp.status, resp.getheader("Content-Type"),
                            resp.getheader("Connection"), resp.read())
        big.close()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        if side == "port":
            mgr.shutdown()
    assert not thread.is_alive()
    return out


@pytest.fixture(scope="module", params=["threaded", "aio"])
def replies(request):
    os.environ["MPI_TPU_ROOF_OPS_PER_S"] = "1e12"
    try:
        yield {side: _run_side(side, request.param)
               for side in ("ref", "port")}
    finally:
        os.environ.pop("MPI_TPU_ROOF_OPS_PER_S", None)


def _families(text):
    helps = sorted(ln for ln in text.splitlines()
                   if ln.startswith(("# HELP", "# TYPE")))
    _types, samples = parse_prometheus(text)
    labels = {(n, tuple(sorted(lb))) for n, lb, _ in samples
              if not n.startswith("mpi_tpu_device_memory_bytes")}
    return helps, labels


@pytest.mark.parametrize("label", LABELS + ["oversized"])
def test_reply_equals_the_references(replies, label):
    ref, ours = replies["ref"][label], replies["port"][label]
    # status, content type and Retry-After (or Connection) equal
    assert ours[:3] == ref[:3], (label, ours[:3], ref[:3])
    if label == "metrics":
        assert _families(ours[3].decode()) == _families(ref[3].decode())
        return
    if ref[1] == GRID:
        assert ours[3] == ref[3]            # frames byte for byte
        return
    a, b = json.loads(ours[3]), json.loads(ref[3])
    assert _scrub(a, PORT_ONLY) == _scrub(b), label


def test_script_answers_what_it_means(replies):
    """The script really exercised each path: the decisions and errors
    the parity above compares are the ones it names."""
    port = replies["port"]
    codes = {k: v[0] for k, v in port.items()}
    for label in ("create-life", "step", "snapshot-binary", "write-binary",
                  "result-wait", "capped-step", "usage", "flights",
                  "timeseries-series", "metrics", "close"):
        assert codes[label] == 200, label
    assert codes["capped-over"] == 429
    assert port["capped-over"][2] == "60"     # the full window
    assert codes["oversized"] == 413
    for label in ("bad-json", "body-not-object", "bad-timeout",
                  "bad-timeout-body", "bad-steps", "partial-viewport",
                  "bad-frame", "write-no-grid", "unknown-tenant",
                  "capped-wrong-tenant", "bad-spec", "timeseries-bad",
                  "flights-bad"):
        assert codes[label] == 400, label
    for label in ("unknown-session", "unknown-ticket", "unknown-route",
                  "closed", "profile-unarmed"):
        assert codes[label] == 404, label
    assert codes["stream"] in (404, 501)
    grid, meta = wire.decode_frame(port["after-write-binary"][3])
    assert meta["generation"] == 23


def test_family_list_is_the_references_extraction():
    core, aio = required_families()
    assert FAMILIES["core"] == tuple(core)
    assert FAMILIES["aio"] == tuple(aio)
    assert FAMILIES["admission"] == tuple(admission_families())
    assert FAMILIES["slo"] == tuple(slo_families())
    assert FAMILIES["flight"] == tuple(flight_families())


def test_armed_scrape_holds_every_listed_family(replies):
    """The port's armed scrape (obs, telemetry, flight, admission; the aio
    families on the aio front) registers every family of the list."""
    _types, samples = parse_prometheus(replies["port"]["metrics"][3].decode())
    text = replies["port"]["metrics"][3].decode()
    names = {ln.split()[2] for ln in text.splitlines()
             if ln.startswith("# TYPE ")}
    want = (set(FAMILIES["core"]) | set(FAMILIES["admission"])
            | set(FAMILIES["slo"]) | set(FAMILIES["flight"]))
    assert want <= names
    aio_names = set(FAMILIES["aio"])
    assert aio_names <= names or not aio_names & names
