"""The port's ``serve`` verb (``python -m mpi_tpu_torch.cli serve``,
``mpi_tpu_torch/serve/cli.py``) on the CPU: ``--tune-cache`` (``auto``
under a state dir), its cluster flags (the
reference's, with the reference's defaults), its default device (no CUDA:
it refuses to serve rather than fall back to the CPU), its startup line,
cluster mode's startup line and refusals; the reference's
server-subprocess SIGKILL restores
(``tests/test_serve_recovery.py``, ``test_serve_async.py``,
``test_serve_durability.py``) against ``--device cpu``; and the
reference's watch tools (``tools/usage_top.py``, ``slo_watch.py``,
``flight_view.py``, which import nothing of ``mpi_tpu``) reading the
port's server, ``usage_top.py`` also against a ``serve --device cpu``
process with no roof set (the roof off the card is the default one).

Every subprocess is killed and reaped in ``finally``, every server thread
joined; each wait for a server has its own time limit.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.models.rules import LIFE
from mpi_tpu.serve import cli as ref_serve_cli
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.serve import cli as serve_cli
from mpi_tpu_torch.serve.httpd import make_server
from mpi_tpu_torch.serve.session import SessionManager

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOOLS = os.path.join(ROOT, "tools")
ENV = dict(os.environ, PYTHONPATH=ROOT)
SERVE = [sys.executable, "-m", "mpi_tpu_torch.cli", "serve", "--port", "0",
         "--device", "cpu"]


def _oracle(rows, cols, seed, steps):
    return evolve_np(init_tile_np(rows, cols, seed), steps, LIFE,
                     "periodic")


def _grid_of(snap):
    return np.array([[int(c) for c in row] for row in snap["grid"]],
                    dtype=np.uint8)


def _wait_for_serving(proc, limit_s=120.0):
    """The bound address from the server's startup line (and the line)."""
    deadline = time.monotonic() + limit_s
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("server exited before announcing its port")
        if "serving on http://" in line:
            addr = line.split("http://", 1)[1].split(" ", 1)[0]
            host, port = addr.rsplit(":", 1)
            return host, int(port), line
    raise AssertionError("server never announced its port")


def _http(host, port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=data,
                                 method=method)
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


@contextlib.contextmanager
def _server_process(args):
    proc = subprocess.Popen(args, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=ENV,
                            cwd=ROOT)
    try:
        host, port, line = _wait_for_serving(proc)
        yield proc, host, port, line
    finally:
        proc.kill()                     # SIGKILL, no shutdown
        proc.wait(timeout=30)
        proc.stdout.close()


# ------------------------------------------------------------ refusals


@pytest.mark.parametrize("flags,item", [
    (["--tune-cache", "auto"], "item 12"),
    (["--peers", "127.0.0.1:1"], "item 11c"),
    (["--peers-file", "peers.txt"], "item 11c"),
    (["--advertise", "127.0.0.1:1"], "item 11c"),
    (["--gossip-interval-s", "2"], "item 11c"),
    (["--peer-timeout-s", "1"], "item 11c"),
    (["--peer-down-s", "1"], "item 11c"),
    (["--peer-dead-s", "1"], "item 11c"),
    (["--proxy-retries", "1"], "item 11c"),
    (["--proxy-backoff-ms", "5"], "item 11c"),
    (["--proxy-timeout-s", "1"], "item 11c"),
])
def test_unported_flags_exit_2_naming_their_item(flags, item, capsys,
                                                tmp_path):
    """Each flag was refused with exit status 2 naming its ROADMAP item
    until the item was ported: ``--tune-cache`` (item 12) now starts the
    server, ``auto`` resolving to ``<state-dir>/tune_cache.json``, and
    the cluster flags (item 11c) parse to the reference's values; nothing
    refuses any of them."""
    if item == "item 12":
        state = str(tmp_path / "state")
        with _server_process(SERVE + ["--state-dir", state, *flags]) as (
                _, host, port, line):
            want = os.path.join(state, "tune_cache.json")
            assert f"tune-cache {want}" in line
            assert _http(host, port, "GET", "/stats")["sessions"] == []
        args = serve_cli.build_parser().parse_args(
            ["--state-dir", state, *flags])
        assert serve_cli.tune_cache_path(args) == want
    ours = serve_cli.build_parser().parse_args(["--port", "0", *flags])
    ref = ref_serve_cli.build_parser().parse_args(["--port", "0", *flags])
    dest = flags[0].lstrip("-").replace("-", "_")
    assert getattr(ours, dest) == getattr(ref, dest)


def test_cluster_flags_keep_the_references_defaults_and_help():
    ours = serve_cli.build_parser()
    ref = ref_serve_cli.build_parser()
    names = ("peers", "peers_file", "advertise", "gossip_interval_s",
             "peer_timeout_s", "peer_down_s", "peer_dead_s",
             "proxy_retries", "proxy_backoff_ms", "proxy_timeout_s")
    a, b = ours.parse_args([]), ref.parse_args([])
    assert {n: getattr(a, n) for n in names} == \
        {n: getattr(b, n) for n in names}
    helps = {act.dest: act.help for act in ours._actions}
    ref_helps = {act.dest: act.help for act in ref._actions}
    assert {n: helps[n] for n in names} == {n: ref_helps[n] for n in names}


def test_cluster_mode_refusals_exit_2(tmp_path, capsys):
    """A missing --peers-file, a junk peer address and dead-after under
    down-after each exit with status 2 and name the fault, as in the
    reference; no gossip thread is left behind."""
    assert serve_cli.serve_main(["--port", "0", "--device", "cpu",
                                 "--peers-file",
                                 str(tmp_path / "missing.txt")]) == 2
    assert "--peers-file" in capsys.readouterr().err
    assert serve_cli.serve_main(["--port", "0", "--device", "cpu",
                                 "--peers", "junk"]) == 2
    assert "error:" in capsys.readouterr().err
    assert serve_cli.serve_main(["--port", "0", "--device", "cpu",
                                 "--peers", "127.0.0.1:1",
                                 "--peer-down-s", "2",
                                 "--peer-dead-s", "1"]) == 2
    assert "must be >= down-after" in capsys.readouterr().err
    assert not [t for t in threading.enumerate()
                if t.name == "mpi_tpu-gossip"]


def test_without_cuda_the_default_device_refuses_to_serve(monkeypatch,
                                                         capsys):
    """No ``--device``: the card.  A box without CUDA fails loudly, exit
    status 2, and never binds a socket or serves on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    made = []
    monkeypatch.setattr("mpi_tpu_torch.serve.httpd.make_server",
                        lambda *a, **kw: made.append(a))
    assert serve_cli.serve_main(["--port", "0"]) == 2
    out = capsys.readouterr()
    assert "CUDA is not available" in out.err
    assert "serving on" not in out.out and not made


def test_bad_values_exit_2(tmp_path, capsys):
    bad = tmp_path / "tenants.json"
    bad.write_text("{nope")
    assert serve_cli.serve_main(["--port", "0", "--device", "cpu",
                                 "--tenants-file", str(bad)]) == 2
    assert "--tenants-file" in capsys.readouterr().err
    assert serve_cli.serve_main(["--port", "0", "--device", "cpu",
                                 "--no-obs", "--admission"]) == 2
    assert "observability" in capsys.readouterr().err


@pytest.mark.parametrize("front", ["threaded", "aio"])
def test_cli_serves_on_the_cpu_with_its_startup_line(front, tmp_path):
    """The reference's startup line, with this port's device and front in
    its extras; both fronts answer the same create/step/snapshot."""
    args = SERVE + ["--front", front, "--admission",
                    "--telemetry-interval-s", "60", "--flight-recorder",
                    "--profile-dir", str(tmp_path)]
    with _server_process(args) as (_proc, host, port, line):
        assert line.startswith(f"[mpi_tpu] serving on http://{host}:{port} "
                               f"(cache size 8, batch window 2.0ms max 8")
        assert "device cpu" in line and "admission (default tenant)" in line
        assert ("front aio (4 workers)" in line) == (front == "aio")
        sid = _http(host, port, "POST", "/sessions",
                    {"rows": 32, "cols": 64, "seed": 4})["id"]
        assert _http(host, port, "POST", f"/sessions/{sid}/step",
                     {"steps": 3})["generation"] == 3
        snap = _http(host, port, "GET", f"/sessions/{sid}/snapshot")
        assert np.array_equal(_grid_of(snap), _oracle(32, 64, 4, 3))
        usage = _http(host, port, "GET", "/usage")
        assert usage["tenants"]["by_tenant"]["default"]["sessions"] == 1
        assert _http(host, port, "GET", "/slo")["worst"] in (
            "ok", "warning", "critical")


def test_cli_cluster_mode_startup_line_and_routes(tmp_path):
    """``--peers`` and ``--peers-file`` merge; the startup line names the
    node, its tag and its peer count; ``/cluster`` answers, ``/healthz``
    carries the cluster block, and ``/metrics`` carries the
    ``host``/``process`` labels and the cluster families."""
    peers = tmp_path / "peers.txt"
    peers.write_text("# seed peers\n127.0.0.1:1\n\n127.0.0.1:2  # two\n")
    args = SERVE + ["--peers", "127.0.0.1:3", "--peers-file", str(peers),
                    "--gossip-interval-s", "3600"]
    with _server_process(args) as (_p, host, port, line):
        me = f"{host}:{port}"
        from mpi_tpu_torch.cluster import node_tag

        assert f"cluster {me} tag {node_tag(me)} peers 3" in line
        info = _http(host, port, "GET", "/cluster")
        assert info["node"] == me and sorted(info["peers"]) == [
            "127.0.0.1:1", "127.0.0.1:2", "127.0.0.1:3"]
        assert _http(host, port, "GET", "/healthz")["cluster"]["tag"] == \
            node_tag(me)
        with urllib.request.urlopen(f"http://{me}/metrics",
                                    timeout=60) as resp:
            text = resp.read().decode()
        assert f'process="{me}"' in text and 'host="' in text
        assert "mpi_tpu_cluster_peers" in text


def test_usage_top_without_a_roof_set_reads_a_float_roof(tmp_path):
    """The roof off the card: ``serve --device cpu`` with
    ``MPI_TPU_ROOF_OPS_PER_S`` unset answers ``/usage`` with the default
    roof as a float and a roofline block on every row, and the
    reference's ``usage_top.py --once`` exits 0 against it."""
    env = {k: v for k, v in ENV.items() if k != "MPI_TPU_ROOF_OPS_PER_S"}
    proc = subprocess.Popen(SERVE, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env,
                            cwd=ROOT)
    try:
        host, port, _line = _wait_for_serving(proc)
        sid = _http(host, port, "POST", "/sessions",
                    {"rows": 32, "cols": 64, "seed": 2})["id"]
        _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 1})
        usage = _http(host, port, "GET", "/usage")
        assert isinstance(usage["roof_ops_per_s"], float)
        assert usage["roof_ops_per_s"] == 132 * 64 * 1.98e9
        assert usage["signatures"] and all(
            "roofline" in row for row in usage["signatures"])
        top = subprocess.run(
            [sys.executable, os.path.join(TOOLS, "usage_top.py"), "--url",
             f"{host}:{port}", "--once"], capture_output=True, text=True,
            timeout=120, cwd=ROOT, env=env)
        assert top.returncode == 0, top.stderr
        assert "32x64/cuda/periodic" in top.stdout
    finally:
        proc.kill()
        proc.wait(timeout=30)
        proc.stdout.close()


# ------------------------------------------------- SIGKILL restores


@pytest.mark.parametrize("backend", ["serial", "cuda"])
def test_sigkill_restart_restores_sessions(tmp_path, backend):
    """SIGKILL the serving process mid-run, restart on the same
    --state-dir: the restored board equals an uninterrupted run."""
    args = SERVE + ["--state-dir", str(tmp_path), "--checkpoint-every", "4"]
    k, m = 6, 4
    with _server_process(args) as (_p, host, port, _line):
        sid = _http(host, port, "POST", "/sessions",
                    {"rows": 32, "cols": 32, "backend": backend,
                     "seed": 21})["id"]
        for _ in range(k):
            _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 1})
    with _server_process(args) as (_p, host, port, line):
        assert "restored 1" in line
        health = _http(host, port, "GET", "/healthz")
        assert health["restored_sessions"] == 1
        for _ in range(m):
            _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 1})
        snap = _http(host, port, "GET", f"/sessions/{sid}/snapshot")
        assert snap["generation"] == k + m
        assert np.array_equal(_grid_of(snap), _oracle(32, 32, 21, k + m))


def test_sigkill_with_tickets_in_flight_restores_completed_prefix(tmp_path):
    """SIGKILL with async tickets in flight: the restored generation is a
    whole number of completed tickets, the board is the oracle's at it,
    and the tickets died with the process."""
    args = SERVE + ["--state-dir", str(tmp_path), "--checkpoint-every", "1"]
    n_tickets, depth = 40, 5
    with _server_process(args) as (_p, host, port, _line):
        sid = _http(host, port, "POST", "/sessions",
                    {"rows": 64, "cols": 64, "backend": "serial",
                     "seed": 23})["id"]
        tickets = [_http(host, port, "POST",
                         f"/sessions/{sid}/step?async=1", {"steps": depth})
                   for _ in range(n_tickets)]
        assert all(t["status"] == "pending" for t in tickets)
        # a prefix completes: the first ticket's resolution, waited for
        first = _http(host, port, "GET",
                      f"/result/{tickets[0]['ticket']}?wait=1")
        assert first["status"] == "done"
    with _server_process(args) as (_p, host, port, _line):
        snap = _http(host, port, "GET", f"/sessions/{sid}/snapshot")
        g = snap["generation"]
        assert depth <= g <= n_tickets * depth
        assert g % depth == 0
        assert np.array_equal(_grid_of(snap), _oracle(64, 64, 23, g))
        with pytest.raises(urllib.error.HTTPError):
            _http(host, port, "GET", "/result/t1")
        _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 3})
        snap2 = _http(host, port, "GET", f"/sessions/{sid}/snapshot")
        assert np.array_equal(_grid_of(snap2), _oracle(64, 64, 23, g + 3))


def test_sigkill_with_journal_and_torn_tail_restores_last_durable(tmp_path):
    args = SERVE + ["--state-dir", str(tmp_path), "--checkpoint-every", "1"]
    k, m = 5, 3
    with _server_process(args) as (proc, host, port, _line):
        sid = _http(host, port, "POST", "/sessions",
                    {"rows": 24, "cols": 24, "backend": "serial",
                     "seed": 17})["id"]
        for _ in range(k):
            _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 1})
        proc.send_signal(signal.SIGKILL)
    jpath = tmp_path / f"{sid}.journal"
    assert jpath.exists(), "checkpoint-every=1 must journal step commits"
    with open(jpath, "ab") as f:
        f.write(b"GOLJ\x01\x02half-an-entry")      # the torn append
    with _server_process(args) as (_p, host, port, _line):
        assert _http(host, port, "GET", "/healthz")["restored_sessions"] == 1
        snap = _http(host, port, "GET", f"/sessions/{sid}/snapshot")
        assert snap["generation"] == k, "torn tail may cost only the tail"
        for _ in range(m):
            _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 1})
        snap = _http(host, port, "GET", f"/sessions/{sid}/snapshot")
        assert np.array_equal(_grid_of(snap), _oracle(24, 24, 17, k + m))


# ------------------------------------------------- the reference's tools


@pytest.fixture(scope="module")
def watched_server():
    """A port server with telemetry and the flight recorder armed, two
    card-engine sessions stepped, sampled twice; shut down after.
    ``usage_top`` renders the roof, which off the card is the default
    (``MPI_TPU_ROOF_OPS_PER_S`` is not set)."""
    obs = Obs()
    mgr = SessionManager(device="cpu", obs=obs)
    obs.arm_telemetry(interval_s=5.0, manager=mgr, start=False)
    obs.arm_flight(manager=mgr, anomaly=True)
    srv = make_server(port=0, manager=mgr)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        host, port = srv.server_address[:2]
        obs.telemetry.sample_once()
        sids = [_http(host, port, "POST", "/sessions",
                      {"rows": 32, "cols": 64, "seed": s})["id"]
                for s in (1, 2)]
        for sid in sids:
            _http(host, port, "POST", f"/sessions/{sid}/step", {"steps": 2})
        obs.telemetry.sample_once()
        yield host, port, sids
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)
        mgr.shutdown()
        obs.close()


def _tool(name, *args):
    return subprocess.run([sys.executable, os.path.join(TOOLS, name), *args],
                          capture_output=True, text=True, timeout=120,
                          cwd=ROOT)


def test_usage_top_reads_the_ports_usage(watched_server):
    host, port, sids = watched_server
    proc = _tool("usage_top.py", "--url", f"{host}:{port}", "--once")
    assert proc.returncode == 0, proc.stderr
    assert "32x64/cuda/periodic" in proc.stdout
    for sid in sids:
        assert sid in proc.stdout


def test_slo_watch_reads_the_ports_slo(watched_server):
    host, port, _ = watched_server
    proc = _tool("slo_watch.py", "--url", f"{host}:{port}", "--once",
                 "--series", "http_requests")
    assert proc.returncode == 0, proc.stderr
    for name in ("availability", "dispatch-p99", "freshness",
                 "http_requests"):
        assert name in proc.stdout


def test_flight_view_reads_the_ports_flights(watched_server):
    host, port, sids = watched_server
    proc = _tool("flight_view.py", "--url", f"http://{host}:{port}", "-v")
    assert proc.returncode == 0, proc.stderr
    assert "32x64/cuda/periodic" in proc.stdout
    assert "dense" in proc.stdout   # the plain version: no card here
    for sid in sids:
        assert sid in proc.stdout


def test_serve_main_exits_0_on_interrupt_and_closes_obs(monkeypatch,
                                                        tmp_path):
    """The reference's shutdown path: a KeyboardInterrupt out of
    ``serve_forever`` prints the shutdown line, closes the server and
    flushes the trace log (``obs.close()`` in ``finally``)."""
    from mpi_tpu_torch.serve import httpd

    closed = []

    class _Interrupted:
        server_address = ("127.0.0.1", 1)

        def serve_forever(self):
            raise KeyboardInterrupt

        def server_close(self):
            closed.append(True)

    monkeypatch.setattr(httpd, "make_server",
                        lambda *a, **kw: _Interrupted())
    obs_closed = []
    real_close = Obs.close
    monkeypatch.setattr(Obs, "close",
                        lambda self: (obs_closed.append(True),
                                      real_close(self)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = serve_cli.serve_main(["--port", "0", "--device", "cpu",
                                   "--trace-log",
                                   str(tmp_path / "trace.jsonl")])
    assert rc == 0 and closed == [True] and obs_closed == [True]
    assert "[mpi_tpu] shutting down" in out.getvalue()
