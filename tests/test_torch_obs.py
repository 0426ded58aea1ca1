"""The port's observability core (``mpi_tpu_torch/obs``) on the CPU: the
non-HTTP scenarios of the reference's ``tests/test_obs.py`` through
``SessionManager(device="cpu", obs=Obs())``; the scrape of the port beside
the reference's (family names, types, help strings and label names equal);
the manager's ``stats()``, ``usage()`` and ``slo()`` beside the reference's
manager for the same scripted traffic, equal but for the timing fields
named in ``TIMING``; boards bit-identical with obs on and off on K1, K2 and
K3 (solo, batched, async and sparse); obs never changing what a failure
does; ``run_profile`` and the device-memory sampler off the card."""

from __future__ import annotations

import json
import os
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from obs_smoke import check_histograms, parse_prometheus  # noqa: E402

from mpi_tpu.obs import Obs as JaxObs  # noqa: E402
from mpi_tpu.obs.metrics import MetricsRegistry as JaxRegistry  # noqa: E402
from mpi_tpu.serve.cache import EngineCache as JaxEngineCache  # noqa: E402
from mpi_tpu.serve.session import SessionManager as JaxManager  # noqa: E402
from mpi_tpu_torch.analysis import obsreg  # noqa: E402
from mpi_tpu_torch.obs import Obs  # noqa: E402
from mpi_tpu_torch.obs import profile as obs_profile  # noqa: E402
from mpi_tpu_torch.obs.devmem import read_device_memory  # noqa: E402
from mpi_tpu_torch.obs.metrics import MetricsRegistry  # noqa: E402
from mpi_tpu_torch.obs.trace import (  # noqa: E402
    current_request_id, reset_request_id, set_request_id,
)
from mpi_tpu_torch.obs.tracectx import (  # noqa: E402
    mint, reset_trace_context, set_trace_context,
)
from mpi_tpu_torch.serve import EngineCache, SessionManager  # noqa: E402
from mpi_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

CUDA_SPEC = {"rows": 64, "cols": 64, "backend": "cuda"}


@pytest.fixture()
def make_manager():
    made = []

    def make(*args, **kw):
        kw.setdefault("device", "cpu")
        mgr = SessionManager(*args, **kw)
        made.append(mgr)
        return mgr

    yield make
    for mgr in made:
        mgr.shutdown()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _close(mgr):
    """Shut the port's manager down; the reference's has no shutdown (its
    dispatch loop is a daemon thread)."""
    if isinstance(mgr, SessionManager):
        mgr.shutdown()


def _values(obs):
    types, samples = parse_prometheus(obs.render_metrics())
    check_histograms(types, samples)
    return {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples}


# ------------------------------------------------ the registry, beside JAX's


def _script_registry(reg):
    c = reg.counter("t_requests_total", "Requests by code")
    c.inc(code="200")
    c.inc(2.0, code="503")
    g = reg.gauge("t_depth", "Queue depth")
    g.set(3.0)
    g.set(1.5, queue="b")
    h = reg.histogram("t_latency_seconds", "Latency", (0.01, 0.1, 1.0))
    for v in (0.001, 0.05, 0.05, 0.5, 3.0):
        h.observe(v, mode="solo")
    h.series(mode="batched").observe(0.02)
    reg.gauge_fn("t_fn", "A callback", lambda: [({"k": "a"}, 1.0),
                                                ({"k": "b"}, 2.0)])
    reg.counter_fn("t_fn_total", "A callback counter", lambda: 7)
    reg.gauge_fn("t_fn", "A callback, rebound", lambda: 4.0)


@pytest.mark.parametrize("openmetrics", [False, True])
@pytest.mark.parametrize("labels", [None, {"host": "h", "process": "1"}])
def test_registry_renders_byte_for_byte_as_the_reference(openmetrics, labels):
    ours, ref = MetricsRegistry(const_labels=labels), JaxRegistry(
        const_labels=labels)
    _script_registry(ours)
    _script_registry(ref)
    assert ours.render(openmetrics=openmetrics) == ref.render(
        openmetrics=openmetrics)


def test_scrape_reads_like_the_references(monkeypatch):
    """The same manager traffic, scraped from both: every family, its
    type, its help string and its label names equal; values differ only
    where they are times or counts of instructions.  Both take the roof
    from ``MPI_TPU_ROOF_OPS_PER_S`` (off the card the port has none)."""
    monkeypatch.setenv("MPI_TPU_ROOF_OPS_PER_S", "1e12")
    out = {}
    for name, mk, ob, backend in (("port", _port_manager, Obs, "cuda"),
                                  ("ref", _ref_manager, JaxObs, "tpu")):
        obs = ob()
        mgr = mk(obs)
        try:
            obs.arm_telemetry(manager=mgr, clock=_Clock(), start=False)
            obs.arm_flight(manager=mgr, anomaly=True, clock=_Clock())
            sid = mgr.create(dict(CUDA_SPEC, backend=backend,
                                  mesh="1x1"))["id"]
            mgr.step(sid, 2)
            obs.telemetry.sample_once()
            text = obs.render_metrics()
        finally:
            _close(mgr)
        helps = sorted(ln for ln in text.splitlines()
                       if ln.startswith(("# HELP", "# TYPE")))
        types, samples = parse_prometheus(text)
        labels = {(n, tuple(sorted(lb))) for n, lb, _ in samples
                  if not n.startswith("mpi_tpu_device_memory_bytes")}
        out[name] = (helps, labels)
    assert out["port"][0] == out["ref"][0]
    assert out["port"][1] == out["ref"][1]


# ------------------------------------------- the manager, beside JAX's

# fields whose values are measured times (or follow from them, or from the
# device the manager runs on, or count instructions by another currency),
# compared by presence only
TIMING = {
    "device_s", "host_s", "flops", "window_ms", "batched_step_s",
    "solo_step_s", "amortized_board_step_s", "compile_wall_s",
    "execute_wall_s", "solo_avg_call_s", "regime", "setup_s", "steady_s",
    "cell_updates_per_s", "last_dispatch_ok_age_s", "cost_cards",
    "roofline", "devices", "t_unix", "age_s", "value", "burn",
    "p50", "p90", "p95", "p99", "p999", "max", "mean", "sum", "burn_fast",
    "burn_slow", "oldest_s", "observed", "tail_ratio", "gens_per_s",
}


def _scrub(x):
    if isinstance(x, dict):
        return {k: ("<measured>" if k in TIMING else _scrub(v))
                for k, v in x.items()}
    if isinstance(x, list):
        return [_scrub(v) for v in x]
    if isinstance(x, str):
        return x.replace("/tpu/", "/cuda/")
    return x


def _port_manager(obs, **kw):
    return SessionManager(EngineCache(max_size=4), obs=obs, device="cpu",
                          batch_window_ms=1000.0, **kw)


def _ref_manager(obs, **kw):
    return JaxManager(JaxEngineCache(max_size=4), obs=obs,
                      batch_window_ms=1000.0, **kw)


def _step_all_concurrently(mgr, sids, steps=1):
    errors = []

    def go(sid):
        try:
            mgr.step(sid, steps)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(s,)) for s in sids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and not any(t.is_alive() for t in threads)


def _scripted_traffic(mgr, obs, backend):
    """Two Life sessions (solo steps, a coalesced round, tickets of two
    depths) and a serial one, under telemetry and the flight recorder at
    injected clocks; returns the manager's three readouts."""
    clock = _Clock()
    obs.arm_telemetry(manager=mgr, clock=clock, start=False)
    obs.arm_flight(manager=mgr, anomaly=True, clock=clock)
    spec = {"rows": 64, "cols": 64, "backend": backend, "mesh": "1x1",
            "segments": [1, 2]}
    sids = [mgr.create(dict(spec, seed=s))["id"] for s in (1, 2)]
    host = mgr.create({"rows": 32, "cols": 32, "backend": "serial",
                       "seed": 3})["id"]
    mgr.step(sids[0], 2)
    mgr.step(host, 3)
    _step_all_concurrently(mgr, sids)
    for t in [mgr.step_async(sids[0], 3), mgr.step_async(sids[1], 1)]:
        mgr.ticket_result(t["ticket"], wait=True, timeout_s=120)
    for _ in range(3):
        clock.t += 5.0
        obs.telemetry.sample_once()
    names = sorted(r["name"] for r in obs.tracer.snapshot()
                   if r["name"] != "lock_wait")
    return mgr.stats(), mgr.usage(), mgr.slo(), names, \
        [mgr.snapshot_array(s)[0] for s in sids]


@pytest.fixture(scope="module")
def side_by_side():
    os.environ["MPI_TPU_ROOF_OPS_PER_S"] = "1e12"
    try:
        out = {}
        for name, mk, ob, backend in (("port", _port_manager, Obs, "cuda"),
                                      ("ref", _ref_manager, JaxObs, "tpu")):
            obs = ob()
            mgr = mk(obs)
            try:
                out[name] = _scripted_traffic(mgr, obs, backend)
            finally:
                _close(mgr)
        yield out
    finally:
        os.environ.pop("MPI_TPU_ROOF_OPS_PER_S", None)


def test_stats_equal_the_references(side_by_side):
    ours, ref = side_by_side["port"][0], side_by_side["ref"][0]
    assert set(ours) == set(ref)
    assert set(ours["obs"]) == set(ref["obs"])
    # the trace's records: lock_wait spans depend on contention timing
    for part in ("cache", "breaker", "failures", "batch", "async"):
        assert _scrub(ours[part]) == _scrub(ref[part]), part
    for part in ("telemetry", "flight", "anomaly", "devmem", "breakdown",
                 "usage"):
        assert _scrub(ours["obs"][part]) == _scrub(ref["obs"][part]), part
    for a, b in zip(ours["sessions"], ref["sessions"]):
        assert set(a) - {"engine_notes"} == set(b) - {"engine_notes"}
        assert _scrub(a.get("usage")) == _scrub(b.get("usage"))
        assert _scrub(a["throughput"]) == _scrub(b["throughput"])


def test_usage_equals_the_references(side_by_side):
    ours, ref = side_by_side["port"][1], side_by_side["ref"][1]
    assert _scrub(ours) == _scrub(ref)
    for a, b in zip(ours["signatures"], ref["signatures"]):
        assert set(a) == set(b)
        if "roofline" in b:
            assert set(a["roofline"]) == set(b["roofline"])
        assert [set(c) for c in a.get("cost_cards", [])] == [
            set(c) for c in b.get("cost_cards", [])]
        assert {c["source"] for c in a.get("cost_cards", [])} <= {
            "kernel_count"}


def test_slo_equals_the_references(side_by_side):
    ours, ref = side_by_side["port"][2], side_by_side["ref"][2]
    assert _scrub(ours) == _scrub(ref)
    assert ours["worst"] == ref["worst"] == "ok"


# the spans only the port emits (README's port span table): an engine that
# carries the manager's obs handle records each pass
PORT_SPANS = ("engine.pass", "seam.extract", "seam.band", "seam.stitch")


def test_trace_and_boards_equal_the_references(side_by_side):
    ours, ref = side_by_side["port"], side_by_side["ref"]
    assert [n for n in ours[3] if n not in PORT_SPANS] == ref[3]
    assert {n for n in ours[3] if n in PORT_SPANS} == {"engine.pass"}
    for a, b in zip(ours[4], ref[4]):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------- the manager's own scenarios


def test_engine_compile_and_dispatch_metrics(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC))["id"]
    mgr.step(sid, 1)
    mgr.step(sid, 1)        # warm: no new warm-up
    vals = _values(obs)
    assert vals[("mpi_tpu_engine_counters_total",
                 (("kind", "compiles"),))] >= 1
    assert vals[("mpi_tpu_engine_counters_total",
                 (("kind", "step_calls"),))] == 2
    assert vals[("mpi_tpu_dispatch_latency_seconds_count",
                 (("mode", "solo"),))] == 2
    assert vals[("mpi_tpu_compile_wall_seconds_count", ())] >= 1
    assert vals[("mpi_tpu_cost_cards", (("source", "kernel_count"),))] >= 1
    names = [r["name"] for r in obs.tracer.snapshot()]
    assert "compile" in names and names.count("device_dispatch") == 2
    assert names.count("compile") == sum(
        e.compile_count for e in mgr.cache.engines())


def test_counters_survive_breaker_open_and_degrade_cycle(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=3,
                        breaker_cooldown_s=60.0)
    obs = Obs()
    mgr = make_manager(cache, obs=obs, step_retries=2,
                       retry_backoff_s=0.001, faults="step:1-3:raise")
    sid = mgr.create(dict(CUDA_SPEC))["id"]
    r = mgr.step(sid, 1)            # 3 failures → breaker opens → degrade
    assert r["generation"] == 1 and mgr.get(sid).degraded
    mgr.step(sid, 2)
    vals = _values(obs)
    assert vals[("mpi_tpu_engine_failures_total", ())] == 3
    assert vals[("mpi_tpu_engine_failures_observed_total", ())] == 3
    assert vals[("mpi_tpu_breaker_trips_total", ())] == 1
    assert vals[("mpi_tpu_breaker_signatures", (("state", "open"),))] == 1
    assert vals[("mpi_tpu_degraded_sessions", ())] == 1
    assert vals[("mpi_tpu_degraded_sessions_total", ())] == 1
    assert vals[("mpi_tpu_dispatch_latency_seconds_count",
                 (("mode", "host"),))] >= 1
    names = [r["name"] for r in obs.tracer.snapshot()]
    assert "engine_failure" in names and "degrade" in names


def test_trace_context_survives_breaker_and_degrade(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=3,
                        breaker_cooldown_s=60.0)
    obs = Obs()
    mgr = make_manager(cache, obs=obs, step_retries=2,
                       retry_backoff_s=0.001, faults="step:1-3:raise")
    sid = mgr.create(dict(CUDA_SPEC))["id"]
    ctx = mint()
    token = set_trace_context(ctx)
    try:
        assert mgr.step(sid, 1)["generation"] == 1
    finally:
        reset_trace_context(token)
    recs = [r for r in obs.tracer.snapshot()
            if r.get("trace_id") == ctx.trace_id]
    assert {"engine_failure", "degrade"} <= {r["name"] for r in recs}
    ctx2 = mint()
    token = set_trace_context(ctx2)
    try:
        mgr.step(sid, 2)
    finally:
        reset_trace_context(token)
    hosts = [r for r in obs.tracer.snapshot() if r["name"] == "host_step"]
    assert hosts and hosts[-1]["trace_id"] == ctx2.trace_id


def test_checkpoint_and_restore_metrics(make_manager, tmp_path):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs,
                       state_dir=str(tmp_path), checkpoint_every=1)
    sid = mgr.create(dict(CUDA_SPEC, seed=5))["id"]
    mgr.step(sid, 2)
    assert obs.checkpoint_write.count() >= 1
    names = {r["name"] for r in obs.tracer.snapshot()}
    assert names & {"checkpoint_write", "journal_append"}
    obs2 = Obs()
    mgr2 = make_manager(EngineCache(max_size=4), obs=obs2,
                        state_dir=str(tmp_path))
    assert mgr2.snapshot(sid)["grid"] == mgr.snapshot(sid)["grid"]
    assert obs2.restore_replay.count() == 1
    assert any(r["name"] == "restore_replay"
               for r in obs2.tracer.snapshot())


def test_request_id_flows_from_contextvar_to_spans(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC))["id"]
    assert current_request_id() is None
    token = set_request_id(99)
    try:
        mgr.step(sid, 1)
    finally:
        reset_request_id(token)
    dispatches = [r for r in obs.tracer.snapshot()
                  if r["name"] == "device_dispatch"]
    assert dispatches and dispatches[-1]["rid"] == 99


def test_window_reads_and_board_writes_leave_records(make_manager):
    obs = Obs()
    obs.arm_flight()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    sid = mgr.create(dict(CUDA_SPEC, seed=2))["id"]
    win, gen, _ = mgr.snapshot_window(sid, 60, 60, 8, 8)
    np.testing.assert_array_equal(win, np.roll(
        mgr.snapshot_array(sid)[0], (-60, -60), (0, 1))[:8, :8])
    mgr.write_window(sid, 0, 0, np.ones((2, 2), np.uint8))
    mgr.write_board(sid, np.zeros((64, 64), np.uint8))
    names = [r["name"] for r in obs.tracer.snapshot()]
    assert names.count("board_write") == 2
    flights = [r for r in obs.flight.snapshot() if r["mode"] == "viewport"]
    assert flights and flights[0]["window"] == {"x0": 60, "y0": 60,
                                                "h": 8, "w": 8}
    assert obs.shard_fetch.count() >= 1


def test_port_span_registry_has_the_engine_spans_and_no_phases():
    """The spans the port's code emits, extracted as the obs-drift rule
    extracts them: the engine's pass and seam band spans, and none of the
    reference's ``phase:*`` (the port's ``PhaseTimer`` has no sink)."""
    spans = obsreg.extract_registry()["spans"]
    assert {name: spans.get(name) for name in (
        "engine.pass", "seam.extract", "seam.band", "seam.stitch")} == {
        "engine.pass": "mpi_tpu_torch/utils/segmenting.py",
        "seam.extract": "mpi_tpu_torch/parallel/seam.py",
        "seam.band": "mpi_tpu_torch/parallel/seam.py",
        "seam.stitch": "mpi_tpu_torch/parallel/seam.py"}
    assert not [n for n in spans if n.startswith("phase:")]
    assert not hasattr(Obs, "phase_sink")
    assert "span_sink" not in PhaseTimer.__dataclass_fields__


# ----------------------------------------------- obs on and off, bit for bit

ENGINE_SPECS = [
    dict(rows=64, cols=64, comm_every=4, segments=[1, 4]),           # K1
    dict(rows=64, cols=50, comm_every=2, segments=[1, 2]),           # K1 seam
    dict(rows=64, cols=64, rule="bosco", segments=[1, 2]),           # K3
    dict(rows=48, cols=48, rule="bosco", comm_every=3,
         boundary="dead", segments=[1, 3]),                          # K2
    dict(rows=64, cols=64, sparse_tile=32, segments=[1]),            # sparse
]


@pytest.mark.parametrize("spec", ENGINE_SPECS, ids=["K1", "K1-seam", "K3",
                                                    "K2", "sparse"])
def test_no_obs_is_bit_identical(make_manager, spec):
    """Solo, coalesced and ticketed steps with obs on (every part armed)
    and off: the same boards, generation for generation."""
    boards = {}
    for label in ("off", "on"):
        obs = None
        if label == "on":
            obs = Obs()
        mgr = make_manager(EngineCache(max_size=4), obs=obs,
                           batch_window_ms=200.0)
        if obs is not None:
            obs.arm_telemetry(manager=mgr, clock=_Clock(), start=False)
            obs.arm_flight(manager=mgr, anomaly=True, clock=_Clock())
        sids = [mgr.create(dict(spec, seed=s))["id"] for s in (4, 5)]
        kid = mgr.get(sids[0]).engine.kernel_id
        mgr.step(sids[0], 1)
        _step_all_concurrently(mgr, sids, spec.get("comm_every", 1))
        for t in [mgr.step_async(s, d) for s, d in zip(sids, (3, 1))]:
            mgr.ticket_result(t["ticket"], wait=True, timeout_s=120)
        boards[label] = (kid, [mgr.snapshot_array(s)[0] for s in sids],
                         [mgr.get(s).generation for s in sids])
        if obs is not None:
            obs.telemetry.sample_once()
            assert obs.flight.stats()["recorded"] > 0
    assert boards["on"][0] == boards["off"][0]
    assert boards["on"][2] == boards["off"][2]
    for a, b in zip(boards["on"][1], boards["off"][1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("with_obs", [False, True])
def test_obs_never_changes_what_a_failure_does(make_manager, with_obs):
    """A real (not injected) failure of an engine: the same outcome, the
    same counts and the same session state with obs on as off; obs only
    records it."""
    obs = Obs() if with_obs else None
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, obs=obs, step_retries=1,
                       retry_backoff_s=0.001, batching=False)
    sid = mgr.create(dict(CUDA_SPEC, seed=6))["id"]

    def broken(site):
        raise RuntimeError(f"{site} failed")

    mgr.get(sid).engine.fault_hook = broken
    r = mgr.step(sid, 1)                 # on the CPU an open breaker degrades
    assert r["generation"] == 1
    s = mgr.get(sid)
    assert (s.degraded, mgr.engine_failures, mgr.degraded_total) == (
        True, 2, 1)
    if with_obs:
        vals = _values(obs)
        assert vals[("mpi_tpu_engine_failures_observed_total", ())] == 2
        fails = [r for r in obs.tracer.snapshot()
                 if r["name"] == "engine_failure"]
        assert len(fails) == 2 and "RuntimeError" in fails[0]["error"]


@pytest.mark.parametrize("with_obs", [False, True])
def test_obs_never_swallows_a_card_engines_failure(make_manager, with_obs):
    """The card's rule with obs on: a real failure of a card engine opens
    the breaker and answers ``EngineUnavailableError``, the session left
    on its engine; obs records the failures and moves nothing (the CPU
    manager stands in for the card by its ``_on_card`` flag)."""
    from mpi_tpu_torch.serve import EngineUnavailableError

    obs = Obs() if with_obs else None
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, obs=obs, step_retries=1,
                       retry_backoff_s=0.001, batching=False)
    mgr._on_card = True
    sid = mgr.create(dict(CUDA_SPEC, seed=7))["id"]
    s = mgr.get(sid)

    def broken(site):
        raise RuntimeError(f"{site} failed")

    s.engine.fault_hook = broken
    with pytest.raises(EngineUnavailableError):
        mgr.step(sid, 1)
    assert mgr.get(sid) is s and not s.degraded and s.engine is not None
    assert (mgr.engine_failures, mgr.degraded_total) == (2, 0)
    assert mgr.health()["ok"] is False
    if with_obs:
        names = [r["name"] for r in obs.tracer.snapshot()]
        assert names.count("engine_failure") == 2 and "degrade" not in names


# ------------------------------------------------------ profiles and memory


def test_run_profile_writes_one_trace_at_a_time(tmp_path):
    assert not obs_profile.capturing.is_set()
    results = []
    t = threading.Thread(target=lambda: results.append(
        obs_profile.run_profile(str(tmp_path), 0.5)))
    t.start()
    assert obs_profile.capturing.wait(30)
    busy = obs_profile.run_profile(str(tmp_path), 0.1)
    t.join(60)
    assert not t.is_alive()
    assert busy == {"ok": False,
                    "error": "a profile capture is already running"}
    (res,) = results
    assert res["ok"] and res["seconds"] == 0.5
    assert os.path.dirname(res["path"]) == str(tmp_path)
    with open(res["path"]) as fh:
        assert "traceEvents" in json.load(fh)
    assert not obs_profile.capturing.is_set()


def test_run_profile_reports_a_bad_logdir(tmp_path):
    (tmp_path / "file").write_text("x")
    res = obs_profile.run_profile(str(tmp_path / "file"), 0.05)
    assert res["ok"] is False and "error" in res
    assert obs_profile.run_profile(str(tmp_path), 0.05)["ok"]


def test_breakdown_names_the_regime(make_manager):
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    assert obs_profile.compile_execute_breakdown(mgr)["regime"] == "idle"
    sid = mgr.create(dict(CUDA_SPEC))["id"]
    mgr.step(sid, 3)
    b = mgr.stats()["obs"]["breakdown"]
    assert b["engines"] == 1 and b["step_calls"] == 1
    assert b["regime"] in ("compile-bound", "dispatch-bound",
                           "compute-bound")


def test_device_memory_off_the_card_is_empty(make_manager):
    assert read_device_memory() == {}
    obs = Obs()
    mgr = make_manager(EngineCache(max_size=4), obs=obs)
    obs.arm_telemetry(manager=mgr, clock=_Clock(), start=False)
    obs.arm_flight(manager=mgr, clock=_Clock())
    mgr.create(dict(CUDA_SPEC))
    obs.telemetry.sample_once()
    st = obs.devmem.stats()
    assert st == {"samples": 1, "errors": 0, "devices": 0,
                  "halo_probe": True}
    assert obs.devmem.memory_total() == 0.0
    vals = _values(obs)
    assert vals[("mpi_tpu_engine_cache_entries",
                 (("cache", "engine"),))] == 1
    # one device: the halo probe finds no mesh and samples nothing
    assert not any(n.startswith("mpi_tpu_halo_exchange_seconds_count")
                   and v for (n, _), v in vals.items())


def test_device_memory_reads_each_initialised_card(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: {
        "allocated_bytes.all.current": 10.0 + i,
        "allocated_bytes.all.peak": 20.0 + i})
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda i: (1.0, 80.0 + i))
    assert read_device_memory() == {
        ("cuda:0", "in_use"): 10.0, ("cuda:0", "peak"): 20.0,
        ("cuda:0", "limit"): 80.0, ("cuda:1", "in_use"): 11.0,
        ("cuda:1", "peak"): 21.0, ("cuda:1", "limit"): 81.0}
