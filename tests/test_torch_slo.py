"""The port's telemetry history and SLO engine (``mpi_tpu_torch/obs/
timeseries.py``, ``obs/slo.py``) on the CPU: the non-HTTP scenarios of the
reference's ``tests/test_slo.py`` under injected clocks (digest accuracy,
window expiry and ring wrap, the burn-rate state machine, objective
validation with the port's ``ConfigError``, default-off purity), the
manager's ``slo()`` and ``health()`` (the reference's ``GET /slo`` and
``/healthz``), and the same digests and SLO snapshots as the reference's
modules for the same feeds."""

import json

import numpy as np
import pytest

from mpi_tpu.obs import Obs as JaxObs
from mpi_tpu.obs.timeseries import WindowedDigest as JaxDigest
from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.obs.slo import (
    SloEngine, default_objectives, load_slo_file, normalize_objectives,
)
from mpi_tpu_torch.obs.timeseries import TelemetryRecorder, WindowedDigest
from mpi_tpu_torch.serve import EngineCache, SessionManager

ARMED_FAMILIES = (
    "mpi_tpu_slo_state",
    "mpi_tpu_slo_transitions_total",
    "mpi_tpu_telemetry_samples_total",
)


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


class _FakeMgr:
    """The one manager surface the SLO engine touches."""

    def __init__(self):
        self.age = None

    def last_dispatch_age_s(self):
        return self.age


def _armed(clock, objectives=None, damp_evals=3, mgr=None, obs_cls=Obs):
    obs = obs_cls()
    mgr = mgr or _FakeMgr()
    tel = obs.arm_telemetry(interval_s=5.0, manager=mgr,
                            objectives=objectives, damp_evals=damp_evals,
                            clock=clock, start=False)
    return obs, tel, obs.slo, mgr


# ------------------------------------------------ digest accuracy


def _distributions(n=20000):
    rng = np.random.default_rng(7)
    half = n // 2
    return {
        "uniform": rng.uniform(1e-4, 10.0, n),
        "bimodal": np.abs(np.concatenate([
            rng.normal(3e-3, 5e-4, half), rng.normal(0.3, 0.02, half)])),
        "heavy_tail": rng.pareto(1.5, n) + 1e-3,
        "lognormal": rng.lognormal(-5.0, 2.0, n),
    }


@pytest.mark.parametrize("name", sorted(_distributions(100)))
def test_digest_quantiles_track_numpy_percentile(name):
    data = _distributions()[name]
    clock = _FakeClock(1000.0)
    dig = WindowedDigest(alpha=0.05, clock=clock)
    ref = JaxDigest(alpha=0.05, clock=clock)
    for v in data:
        dig.observe(float(v))
        ref.observe(float(v))
    assert dig.count(3600.0, now=clock.t) == len(data)
    for q in (0.5, 0.95, 0.99):
        est = dig.quantile(q, 3600.0, now=clock.t)
        assert est == ref.quantile(q, 3600.0, now=clock.t)
        true = float(np.percentile(data, q * 100.0))
        rel = abs(est - true) / true
        rank_err = abs(float(np.mean(data <= est)) - q)
        assert rel <= 0.055 or rank_err <= 0.011, (
            f"{name} q={q}: est={est:.6g} true={true:.6g} "
            f"rel={rel:.4f} rank_err={rank_err:.4f}")
    assert dig.summary(3600.0, now=clock.t) == ref.summary(3600.0,
                                                          now=clock.t)


def test_digest_fraction_above_straddling_bucket_counts_under():
    dig = WindowedDigest(alpha=0.05, clock=_FakeClock(0.0))
    for _ in range(10):
        dig.observe(1.0)
    assert dig.fraction_above(1.0, 60.0, now=0.0) == 0.0
    for _ in range(10):
        dig.observe(1.5)
    assert dig.fraction_above(1.0, 60.0, now=0.0) == pytest.approx(0.5)


def test_digest_empty_and_validation():
    dig = WindowedDigest(clock=_FakeClock())
    assert dig.quantile(0.5, 60.0) is None
    assert dig.summary(60.0)["count"] == 0
    assert dig.fraction_above(1.0, 60.0) == 0.0
    with pytest.raises(ValueError):
        WindowedDigest(alpha=1.5)


# ------------------------------------------------ window expiry/rotation


def test_digest_windows_expire_under_fake_clock():
    clock = _FakeClock(0.0)
    dig = WindowedDigest(clock=clock)
    for _ in range(10):
        dig.observe(0.1)
    clock.t = 50.0
    for _ in range(5):
        dig.observe(0.2)
    assert dig.count(60.0, now=50.0) == 15
    assert dig.count(60.0, now=70.0) == 5
    assert dig.count(60.0, now=400.0) == 0
    assert dig.count(3600.0, now=400.0) == 15
    summ = dig.summary(3600.0, now=400.0)
    assert summ["count"] == 15 and summ["p50"] is not None


def test_digest_ring_wrap_reuses_slice_position():
    clock = _FakeClock(0.0)
    dig = WindowedDigest(max_window_s=3600.0, clock=clock)
    for _ in range(7):
        dig.observe(0.1)
    clock.t = dig._nslices * WindowedDigest.SLICE_S
    for _ in range(2):
        dig.observe(0.1)
    assert dig.count(3600.0, now=clock.t) == 2


def test_recorder_window_delta_and_rates_under_fake_clock():
    clock = _FakeClock(0.0)
    obs = Obs()
    obs.metrics.gauge_fn("mpi_tpu_sessions", "live", lambda: 3)
    tel = TelemetryRecorder(obs.metrics, interval_s=5.0, clock=clock)
    tel.sample_once()
    obs.http_requests.inc(10, method="GET", path="/x", code="200")
    clock.t = 5.0
    tel.sample_once()
    obs.http_requests.inc(5, method="GET", path="/x", code="200")
    clock.t = 10.0
    tel.sample_once()
    assert tel.window_delta("http_requests", 4.0, now=10.0) == 5.0
    assert tel.window_delta("http_requests", 7.5, now=10.0) == 15.0
    assert tel.window_delta("http_requests", 9999.0, now=10.0) == 15.0
    pts = tel.points("http_requests", 3600.0, now=10.0)
    assert pts == [[5.0, 2.0], [10.0, 1.0]]
    assert tel.points("sessions", 3600.0, now=10.0) == [
        [0.0, 3.0], [5.0, 3.0], [10.0, 3.0]]
    assert tel.stats()["samples"] == 3
    assert "http_5xx" in tel.series_names()


# ------------------------------------------------ burn-rate state machine


def test_availability_worsens_immediately_and_recovers_damped():
    clock = _FakeClock(0.0)
    obs, tel, slo, _ = _armed(clock)
    tel.sample_once()
    for code in ("200",) * 20 + ("500",) * 20:
        obs.http_requests.inc(method="POST", path="/step", code=code)
    clock.t = 10.0
    tel.sample_once()
    assert slo.worst() == "critical"
    assert slo.transitions_total() == 1
    text = obs.render_metrics()
    assert 'mpi_tpu_slo_state{slo="availability"} 2' in text
    assert ('mpi_tpu_slo_transitions_total'
            '{slo="availability",to="critical"} 1') in text
    for i in (1, 2):
        obs.http_requests.inc(100, method="POST", path="/step", code="200")
        clock.t = 10.0 + 400.0 * i
        tel.sample_once()
        assert slo.worst() == "critical", f"eval {i} must stay damped"
    obs.http_requests.inc(100, method="POST", path="/step", code="200")
    clock.t = 10.0 + 1200.0
    tel.sample_once()
    assert slo.worst() == "ok"
    assert slo.transitions_total() == 2
    snap = slo.snapshot()
    assert snap["worst"] == "ok" and snap["evals"] == 5
    assert {(t["slo"], t["to"]): t["count"]
            for t in snap["transitions"]} == {
        ("availability", "critical"): 1, ("availability", "ok"): 1}


def test_relapse_resets_the_recovery_streak_without_ringing():
    clock = _FakeClock(0.0)
    obs, tel, slo, _ = _armed(clock)
    tel.sample_once()
    obs.http_requests.inc(20, method="POST", path="/step", code="500")
    clock.t = 10.0
    tel.sample_once()
    assert slo.worst() == "critical" and slo.transitions_total() == 1
    for i in (1, 2):
        obs.http_requests.inc(50, method="POST", path="/step", code="200")
        clock.t = 10.0 + 400.0 * i
        tel.sample_once()
    obs.http_requests.inc(20, method="POST", path="/step", code="500")
    clock.t += 10.0
    tel.sample_once()
    assert slo.worst() == "critical" and slo.transitions_total() == 1
    for _ in (1, 2):
        obs.http_requests.inc(50, method="POST", path="/step", code="200")
        clock.t += 400.0
        tel.sample_once()
        assert slo.worst() == "critical"


def test_fast_spike_with_calm_slow_window_stays_quiet():
    clock = _FakeClock(0.0)
    obs, tel, slo, _ = _armed(clock)
    tel.sample_once()
    for i in range(1, 13):
        obs.http_requests.inc(1000, method="POST", path="/step", code="200")
        clock.t = 300.0 * i
        tel.sample_once()
    assert slo.worst() == "ok"
    obs.http_requests.inc(30, method="POST", path="/step", code="500")
    obs.http_requests.inc(30, method="POST", path="/step", code="200")
    clock.t = 3660.0
    tel.sample_once()
    avail = [r for r in slo.snapshot()["slos"]
             if r["name"] == "availability"][0]
    assert avail["burn"]["fast"] > 14.4
    assert avail["burn"]["slow"] < 6.0
    assert slo.worst() == "ok" and slo.transitions_total() == 0
    obs.http_requests.inc(300, method="POST", path="/step", code="500")
    clock.t = 3670.0
    tel.sample_once()
    assert slo.worst() == "critical"


def test_freshness_thresholds_and_never_dispatched():
    clock = _FakeClock(0.0)
    obs, tel, slo, mgr = _armed(clock, damp_evals=1)
    tel.sample_once()
    assert slo.worst() == "ok"
    mgr.age = 480.0
    clock.t = 10.0
    tel.sample_once()
    assert [r["state"] for r in slo.snapshot()["slos"]
            if r["name"] == "freshness"] == ["warning"]
    mgr.age = 700.0
    clock.t = 20.0
    tel.sample_once()
    assert slo.worst() == "critical"
    mgr.age = 30.0
    clock.t = 30.0
    tel.sample_once()
    assert slo.worst() == "ok"


def test_latency_objective_burns_on_fraction_over_threshold():
    clock = _FakeClock(0.0)
    obs, tel, slo, _ = _armed(clock, objectives=[
        {"name": "lat", "type": "latency", "path": "dispatch",
         "threshold_s": 0.1, "target": 0.95}])
    for _ in range(20):
        tel.dispatch_digest.observe(0.01)
    clock.t = 10.0
    tel.sample_once()
    assert slo.worst() == "ok"
    for _ in range(80):
        tel.dispatch_digest.observe(0.5)
    clock.t = 20.0
    tel.sample_once()
    assert slo.worst() == "critical"
    row = slo.snapshot()["slos"][0]
    assert row["detail"]["fast"]["over_threshold"] == pytest.approx(
        0.8, abs=0.01)


def _feed_both(obs, tel, mgr, clock):
    tel.sample_once()
    for code in ("200",) * 20 + ("500",) * 20:
        obs.http_requests.inc(method="POST", path="/step", code=code)
    for v in (0.01,) * 20 + (0.5,) * 5:
        tel.dispatch_digest.observe(v)
    mgr.age = 480.0
    clock.t = 10.0
    tel.sample_once()
    obs.http_requests.inc(500, method="POST", path="/step", code="200")
    mgr.age = 20.0
    clock.t = 410.0
    tel.sample_once()


def test_slo_snapshots_equal_the_references():
    """The same feed under the same clock: the reference's SLO engine and
    the port's give the same snapshot, compact form and scrape lines."""
    out = []
    for cls in (Obs, JaxObs):
        clock = _FakeClock(0.0)
        obs, tel, slo, mgr = _armed(clock, obs_cls=cls)
        _feed_both(obs, tel, mgr, clock)
        text = [ln for ln in obs.render_metrics().splitlines()
                if ln.startswith(ARMED_FAMILIES)]
        out.append((slo.snapshot(), slo.compact(), slo.health_block(),
                    text, tel.stats()))
    assert out[0] == out[1]


def test_arm_telemetry_is_idempotent():
    obs = Obs()
    tel = obs.arm_telemetry(interval_s=5.0, start=False)
    assert obs.arm_telemetry(interval_s=99.0, start=False) is tel
    assert obs.telemetry is tel and obs.slo is not None


# ------------------------------------------------ objective validation


@pytest.mark.parametrize("raw,msg", [
    ({"type": "nope"}, "objective type"),
    ({"type": "availability"}, "target must be a ratio"),
    ({"type": "availability", "target": 1.5}, "target must be a ratio"),
    ({"type": "latency", "target": 0.9, "path": "nope", "threshold_s": 1.0},
     "path must be one of"),
    ({"type": "latency", "target": 0.9, "threshold_s": -1},
     "threshold_s must be > 0"),
    ({"type": "freshness", "max_age_s": 0}, "max_age_s must be > 0"),
    ({"type": "freshness", "max_age_s": 5, "warn_burn": 3, "crit_burn": 2},
     "must not exceed crit_burn"),
    ({"type": "freshness", "max_age_s": 5, "bogus": 1}, "unknown keys"),
    ("not-a-dict", "must be an object"),
])
def test_objective_validation_names_the_offending_field(raw, msg):
    from mpi_tpu.config import ConfigError as JaxConfigError
    from mpi_tpu.obs.slo import normalize_objectives as jax_normalize

    with pytest.raises(ConfigError, match=msg) as ours:
        normalize_objectives([raw])
    with pytest.raises(JaxConfigError) as ref:
        jax_normalize([raw])
    assert str(ours.value) == str(ref.value)


def test_objective_list_validation():
    with pytest.raises(ConfigError, match="duplicate objective name"):
        normalize_objectives([
            {"name": "x", "type": "freshness", "max_age_s": 5},
            {"name": "x", "type": "availability", "target": 0.99}])
    with pytest.raises(ConfigError, match="non-empty objectives list"):
        normalize_objectives([])
    with pytest.raises(ConfigError, match='"objectives" list'):
        normalize_objectives({"damp_evals": 2})
    with pytest.raises(ConfigError, match="damp_evals must be an int"):
        normalize_objectives({"objectives": default_objectives(),
                              "damp_evals": 0})
    with pytest.raises(ConfigError, match="unknown top-level keys"):
        normalize_objectives({"objectives": default_objectives(),
                              "bogus": 1})
    objs, opts = normalize_objectives(
        {"objectives": default_objectives(), "damp_evals": 5})
    assert opts == {"damp_evals": 5} and len(objs) == 3


def test_load_slo_file_errors_and_roundtrip(tmp_path):
    with pytest.raises(ConfigError, match="cannot read slo file"):
        load_slo_file(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    with pytest.raises(ConfigError, match="is not JSON"):
        load_slo_file(str(bad))
    good = tmp_path / "slo.json"
    good.write_text(json.dumps({
        "objectives": [{"name": "avail", "type": "availability",
                        "target": 0.99, "warn_burn": 2.0,
                        "crit_burn": 4.0}],
        "damp_evals": 2}))
    objs, opts = load_slo_file(str(good))
    assert objs[0]["crit_burn"] == 4.0 and opts["damp_evals"] == 2


# ------------------------------------------------ the manager's readouts


def test_unarmed_manager_has_no_slo_and_health_has_no_slo_block():
    obs = Obs()
    mgr = SessionManager(EngineCache(max_size=4), obs=obs, device="cpu")
    try:
        with pytest.raises(RuntimeError, match="armed telemetry"):
            mgr.slo()
        assert "slo" not in mgr.health()
    finally:
        mgr.shutdown()


def test_critical_slo_never_flips_health_ok():
    obs = Obs()
    mgr = SessionManager(EngineCache(max_size=4), obs=obs, device="cpu")
    try:
        obs.arm_telemetry(interval_s=5.0, manager=mgr, clock=_FakeClock(),
                          start=False)
        sid = mgr.create({"rows": 16, "cols": 32})["id"]
        mgr.step(sid, 2)
        obs.telemetry.sample_once()
        obs.http_requests.inc(30, method="POST", path="/step", code="500")
        obs.telemetry.sample_once()
        doc = mgr.slo()
        assert doc["worst"] == "critical" and "cluster" not in doc
        h = mgr.health()
        assert h["ok"] is True
        assert h["slo"]["worst"] == "critical"
        assert h["slo"]["burning"] == ["availability"]
        ts = obs.telemetry.points("sessions", 3600.0)
        assert ts and ts[-1][1] == 1.0
    finally:
        mgr.shutdown()


def _drive(obs):
    obs.http_requests.inc(method="GET", path="/x", code="200")
    obs.http_requests.inc(method="POST", path="/step", code="500")
    obs.dispatch_solo.observe(0.01)
    obs.dispatch_batched.observe(0.02)
    with obs.span("outer", kind="test"):
        obs.event("evt", foo=1)


def test_unarmed_scrape_is_the_armed_scrape_minus_the_new_families():
    unarmed, armed = Obs(), Obs()
    armed.arm_telemetry(interval_s=5.0, manager=_FakeMgr(),
                        clock=_FakeClock(), start=False)
    _drive(unarmed)
    _drive(armed)

    def shared(text):
        return [ln for ln in text.splitlines()
                if not any(f in ln for f in ARMED_FAMILIES)]

    u, a = unarmed.render_metrics(), armed.render_metrics()
    assert shared(u) == u.splitlines()
    for fam in ARMED_FAMILIES:
        assert fam not in u and fam in a
    assert shared(a) == u.splitlines()
    u_jsonl = "\n".join(json.dumps(r, sort_keys=True)
                        for r in unarmed.tracer.snapshot())
    assert "slo" not in u_jsonl
    assert ([r["name"] for r in armed.tracer.snapshot()]
            == [r["name"] for r in unarmed.tracer.snapshot()])
    assert unarmed.telemetry is None and unarmed.slo is None


def test_slo_transition_emits_one_trace_event():
    clock = _FakeClock(0.0)
    obs, tel, slo, _ = _armed(clock)
    tel.sample_once()
    obs.http_requests.inc(20, method="POST", path="/step", code="500")
    clock.t = 10.0
    tel.sample_once()
    recs = [r for r in obs.tracer.snapshot()
            if r["name"] == "slo_transition"]
    assert len(recs) == 1
    rec = recs[0]
    assert (rec["slo"], rec["from"], rec["to"]) == (
        "availability", "ok", "critical")
    assert rec["burn_fast"] > 14.4 and rec["burn_slow"] > 14.4


def test_engine_accepts_raw_objectives_and_snapshot_shape():
    clock = _FakeClock(0.0)
    tel = TelemetryRecorder(Obs().metrics, interval_s=5.0, clock=clock)
    eng = SloEngine(default_objectives(), tel, clock=clock)
    eng.evaluate(0.0)
    snap = eng.snapshot()
    assert snap["windows_s"] == {"fast": 300.0, "slow": 3600.0}
    assert {r["name"] for r in snap["slos"]} == {
        "availability", "dispatch-p99", "freshness"}
    for row in snap["slos"]:
        assert row["state"] == "ok"
        assert set(row["burn"]) == {"fast", "slow"}
        assert row["thresholds"]["warn"] <= row["thresholds"]["crit"]
    assert set(snap["windows"]) == {"dispatch", "http", "ticket_wait"}
    compact = eng.compact()
    assert compact["worst"] == "ok" and compact["transitions"] == 0
    assert set(compact["windows"]) == {"dispatch", "http", "ticket_wait"}
