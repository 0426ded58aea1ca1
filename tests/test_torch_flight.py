"""The port's flight recorder and anomaly detector (``mpi_tpu_torch/obs/
flight.py``, ``obs/anomaly.py``) on the CPU: the non-HTTP scenarios of the
reference's ``tests/test_flight.py`` under injected clocks — ring
semantics, record fields against the engine that stepped (the kernel, its
generations per launch), drift detection both ways with damped recovery,
the capture duty cycle, the unarmed path recording nothing, and the
end-to-end regression through ``SessionManager`` (the reference's goes
through its HTTP front) — and the same records from the port's modules
and the reference's for the same calls."""

import json
import os

import pytest

from mpi_tpu.obs.anomaly import AnomalyDetector as JaxDetector
from mpi_tpu.obs.flight import FlightRecorder as JaxRecorder
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import BOSCO
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.obs.anomaly import AnomalyDetector
from mpi_tpu_torch.obs.flight import FlightRecorder, engine_kind
from mpi_tpu_torch.obs.tracectx import mint, reset_trace_context, \
    set_trace_context
from mpi_tpu_torch.serve import EngineCache, SessionManager


class _FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


class _Cfg:
    def __init__(self, comm_every=1, boundary="closed"):
        self.comm_every = comm_every
        self.boundary = boundary


class _Device:
    def __init__(self, type):
        self.type = type


class _FakeEngine:
    """The attribute surface ``FlightRecorder.record`` derives from."""

    def __init__(self, sig="64x64/cuda/test", sparse_plan=None, pad_bits=0,
                 boundary="closed", device="cpu", donates=False, tuned=None,
                 bitpacked=False, k=1, kernel=None, depth=None):
        self.sig_label = sig
        self.sparse_plan = sparse_plan
        self.pad_bits = pad_bits
        self.device = _Device(device)
        self.donates_input = donates
        self.tuned_plan = tuned
        self.bitpacked = bitpacked
        self.config = _Cfg(comm_every=k, boundary=boundary)
        if kernel is not None:
            self.kernel_id = kernel
        if depth is not None:
            self.depth = depth


# ------------------------------------------------ engine classification


def test_engine_kind_classification():
    assert engine_kind(_FakeEngine()) == "dense"
    assert engine_kind(_FakeEngine(device="cuda")) == "fused"
    assert engine_kind(
        _FakeEngine(pad_bits=8, boundary="periodic")) == "seam"
    assert engine_kind(_FakeEngine(sparse_plan=object())) == "sparse"
    assert engine_kind(_FakeEngine(sparse_plan=object(), device="cuda",
                                   pad_bits=8,
                                   boundary="periodic")) == "sparse"


@pytest.mark.parametrize("kw,kind", [
    (dict(cols=64), "dense"), (dict(cols=50), "seam"),
    (dict(cols=64, rule=BOSCO), "dense"),
    (dict(cols=64, sparse_tile=32), "sparse")])
def test_engine_kind_of_real_engines_off_the_card(kw, kind):
    eng = port.build_engine(GolConfig(rows=64, steps=0, **kw), device="cpu")
    assert engine_kind(eng) == kind


# ------------------------------------------------ ring semantics


def test_ring_overwrite_keeps_newest_and_counts_drops():
    fl = FlightRecorder(capacity=4)
    for i in range(10):
        fl.record("solo", engine=_FakeEngine(), steps=i + 1)
    assert fl.stats() == {"capacity": 4, "recorded": 10, "dropped": 6}
    recs = fl.snapshot()
    assert [r["seq"] for r in recs] == [6, 7, 8, 9]
    assert [r["steps"] for r in recs] == [7, 8, 9, 10]
    assert all("t_unix" in r and "t_mono" not in r for r in recs)


def test_ring_wrap_emits_one_flight_drop_per_turn():
    obs = Obs()
    try:
        fl = FlightRecorder(capacity=4, obs=obs)
        for _ in range(9):
            fl.record("solo", engine=_FakeEngine())
        drops = [r for r in obs.tracer.snapshot()
                 if r["name"] == "flight_drop"]
        assert [(d["dropped"], d["total"]) for d in drops] == \
            [(4, 4), (4, 8)]
    finally:
        obs.close()


def test_ring_capacity_must_be_positive():
    with pytest.raises(ValueError):
        FlightRecorder(capacity=0)


# ------------------------------------------------ record field parity


def test_record_parity_fused_engine():
    fl = FlightRecorder(capacity=8)
    eng = _FakeEngine(sig="512x512/cuda/fused", device="cuda", k=3,
                      donates=True, tuned=object(), bitpacked=True,
                      kernel="K1")
    rec = fl.record("solo", engine=eng, steps=7, session="s1",
                    setup_s=0.5, device_s=0.25, block_s=0.125)
    assert rec["engine"] == "fused" and rec["kernel"] == "K1"
    assert rec["signature"] == eng.sig_label
    assert rec["k"] == 3
    assert rec["segments"] == {"full": 2, "rem": 1}
    assert rec["donated"] and rec["tuned"] and rec["bitpacked"]
    assert (rec["setup_s"], rec["device_s"], rec["block_s"]) == \
        (0.5, 0.25, 0.125)


def test_record_k_is_the_generations_a_launch():
    """K2 runs comm_every 7 at r 5 as passes of 3: the record's ``k`` and
    segments are the launches', not the requested depth's."""
    eng = port.build_engine(GolConfig(rows=64, cols=64, steps=0, rule=BOSCO,
                                      comm_every=7), device="cpu")
    rec = FlightRecorder(capacity=2).record("solo", engine=eng, steps=8)
    assert (rec["kernel"], rec["k"]) == ("K2", 3)
    assert rec["segments"] == {"full": 2, "rem": 2}


def test_record_parity_sparse_stats_passed_never_recomputed():
    fl = FlightRecorder(capacity=8)
    rec = fl.record("solo", engine=_FakeEngine(sparse_plan=object()),
                    steps=1, session="s1",
                    sparse={"active_tiles": 5, "active_fraction": 0.125,
                            "mode": "tile"})
    assert rec["engine"] == "sparse"
    assert rec["sparse"] == {"active_tiles": 5, "active_fraction": 0.125,
                             "rung": "tile"}


def test_record_parity_batched_riders():
    fl = FlightRecorder(capacity=8)
    rec = fl.record("batched", engine=_FakeEngine(), steps=4, batch=3,
                    sessions=["a", "b", "c"], request_ids=[7, 8, 9],
                    links=["ab" * 16 + ":" + "cd" * 8])
    assert rec["batch"] == 3
    assert rec["sessions"] == ["a", "b", "c"]
    assert rec["request_ids"] == [7, 8, 9]
    assert rec["links"] == ["ab" * 16 + ":" + "cd" * 8]


def test_record_host_mode_has_no_engine_facts():
    rec = FlightRecorder(capacity=8).record("host", steps=3, session="s1",
                                            device_s=0.01)
    assert rec["engine"] == "host"
    assert "signature" not in rec and "k" not in rec


def test_on_record_feed_gets_signature_and_wall():
    fl = FlightRecorder(capacity=8)
    seen = []
    fl.on_record = lambda sig, wall, tid: seen.append((sig, wall, tid))
    fl.record("solo", engine=_FakeEngine(sig="sigA"), steps=1,
              device_s=0.25)
    fl.record("host", steps=1, device_s=0.5)
    fl.record("viewport", engine=_FakeEngine(sig="sigA"), device_s=0.5)
    assert seen == [("sigA", 0.25, None), (None, 0.5, None)]


@pytest.mark.parametrize("mode,kw", [
    ("solo", dict(steps=5, session="s1", setup_s=0.5, device_s=0.25,
                  block_s=0.125)),
    ("batched", dict(steps=4, batch=3, sessions=["a", "b", "c"],
                     request_ids=[7, 8, 9])),
    ("host", dict(steps=3, session="s1", device_s=0.01)),
    ("viewport", dict(session="s1", window=(1, 2, 3, 4),
                      shards_touched=1, device_s=0.001)),
])
def test_records_equal_the_references(mode, kw):
    """The same calls on both recorders give the same records, field for
    field, but for the port's kernel id and its wall-clock stamps."""
    eng = None if mode == "host" else _FakeEngine(k=3, bitpacked=True)
    ours = FlightRecorder(capacity=4).record(mode, engine=eng, **kw)
    ref = JaxRecorder(capacity=4).record(mode, engine=eng, **kw)
    for rec in (ours, ref):
        rec.pop("t_mono")
    assert ours == ref


# ------------------------------------------------ snapshot filters


def _filter_ring():
    fl = FlightRecorder(capacity=16)
    fl.record("solo", engine=_FakeEngine(sig="sigA"), steps=1,
              session="s1", device_s=0.01)
    fl.record("solo", engine=_FakeEngine(sig="sigB"), steps=1,
              session="s2", device_s=0.20)
    fl.record("batched", engine=_FakeEngine(sig="sigA"), steps=1, batch=2,
              sessions=["s1", "s3"], device_s=0.05,
              links=["f" * 32 + ":" + "0" * 16])
    return fl


def test_snapshot_filters():
    fl = _filter_ring()
    assert len(fl.snapshot()) == 3
    assert [r["seq"] for r in fl.snapshot(session="s1")] == [0, 2]
    assert [r["seq"] for r in fl.snapshot(session="s3")] == [2]
    assert [r["seq"] for r in fl.snapshot(signature="sigA")] == [0, 2]
    assert [r["seq"] for r in fl.snapshot(slower_than=0.05)] == [1]
    assert [r["seq"] for r in fl.snapshot(slower_than=0.04)] == [1, 2]
    assert [r["seq"] for r in fl.snapshot(trace="f" * 32)] == [2]
    assert fl.snapshot(trace="0" * 32) == []
    assert [r["seq"] for r in fl.snapshot(limit=2)] == [1, 2]


def test_dump_writes_export_form_jsonl(tmp_path):
    fl = _filter_ring()
    path = str(tmp_path / "ring.flights.jsonl")
    assert fl.dump(path) == 3
    lines = [json.loads(x) for x in
             open(path, encoding="utf-8").read().splitlines()]
    assert [r["seq"] for r in lines] == [0, 1, 2]
    assert all("t_unix" in r for r in lines)


# ------------------------------------------------ real step parity


@pytest.mark.parametrize("spec,kid", [
    ({"rows": 16, "cols": 32, "comm_every": 2}, "K1"),
    ({"rows": 32, "cols": 32, "rule": "bosco"}, "K3"),
    ({"rows": 32, "cols": 32, "rule": "bosco", "comm_every": 3}, "K2")])
def test_solo_dispatch_record_matches_engine(spec, kid):
    obs = Obs()
    mgr = SessionManager(EngineCache(max_size=2), obs=obs, batching=False,
                         device="cpu")
    try:
        obs.arm_flight(capacity=8)
        info = mgr.create(dict(spec, segments=[3]))
        mgr.step(info["id"], 3)
        (rec,) = obs.flight.snapshot()
        eng = mgr.get(info["id"]).engine
        assert rec["mode"] == "solo" and rec["session"] == info["id"]
        assert rec["steps"] == 3 and rec["kernel"] == kid == eng.kernel_id
        assert rec["signature"] == eng.sig_label
        assert rec["engine"] == engine_kind(eng) == "dense"
        assert rec["k"] == eng.depth
        assert rec["device_s"] > 0.0 and rec["block_s"] >= 0.0
    finally:
        mgr.shutdown()
        obs.close()


def test_unarmed_manager_records_nothing():
    obs = Obs()
    mgr = SessionManager(EngineCache(max_size=2), obs=obs, batching=False,
                         device="cpu")
    try:
        sid = mgr.create({"rows": 16, "cols": 32})["id"]
        mgr.step(sid, 2)
        assert obs.flight is None and obs.anomaly is None
        text = obs.render_metrics()
        for fam in ("mpi_tpu_flight", "mpi_tpu_anomaly",
                    "mpi_tpu_dispatch_anomalies", "mpi_tpu_device_memory"):
            assert fam not in text
        kinds = {r["name"] for r in obs.tracer.snapshot()}
        assert not kinds & {"flight_drop", "dispatch_anomaly"}
    finally:
        mgr.shutdown()
        obs.close()


# ------------------------------------------------ drift detection


def _feed(det, clock, sig, wall, n, gap_s, tids=False):
    for i in range(n):
        clock.t += gap_s
        det.observe(sig, wall, f"{i:032x}" if tids else None)


def _slow_drift(det, clock, sig="sig", tids=True):
    _feed(det, clock, sig, 0.010, 40, 9.0)
    clock.t += 301.0
    _feed(det, clock, sig, 0.050, 16, 1.0, tids=tids)
    det.evaluate(clock.t)


def test_detector_fires_on_latency_step_and_damps_recovery(tmp_path):
    obs = Obs()
    clock = _FakeClock()
    caps = []
    try:
        det = AnomalyDetector(obs, clock=clock, profile_dir=str(tmp_path),
                              capture_fn=lambda d, s: caps.append(d))
        _slow_drift(det, clock)
        snap = det.snapshot()
        assert snap["signatures"][0]["state"] == "slow"
        (ep,) = snap["episodes"]
        assert ep["direction"] == "slow"
        assert ep["ratios"]["1m"] >= 2.0 and ep["ratios"]["5m"] >= 2.0
        assert len(ep["exemplars"]) == 3
        assert len(caps) == 1
        assert os.path.basename(caps[0]).startswith("anomaly-")
        assert ep["capture_dir"] == caps[0]
        events = [r for r in obs.tracer.snapshot()
                  if r["name"] == "dispatch_anomaly"]
        assert len(events) == 1 and events[0]["capture"] == caps[0]
        det.evaluate(clock.t)
        assert len(det.snapshot()["episodes"]) == 1 and len(caps) == 1
        clock.t += 301.0
        _feed(det, clock, "sig", 0.010, 16, 1.0)
        for i in range(3):
            det.evaluate(clock.t)
            want = "slow" if i < 2 else "ok"
            assert det.snapshot()["signatures"][0]["state"] == want
        assert len(det.snapshot()["episodes"]) == 1
    finally:
        obs.close()


def test_detector_fires_fast_direction_without_capture(tmp_path):
    obs = Obs()
    clock = _FakeClock()
    caps = []
    try:
        det = AnomalyDetector(obs, clock=clock, profile_dir=str(tmp_path),
                              capture_fn=lambda d, s: caps.append(d))
        _feed(det, clock, "sig", 0.010, 40, 9.0)
        clock.t += 301.0
        _feed(det, clock, "sig", 0.002, 16, 1.0)
        det.evaluate(clock.t)
        snap = det.snapshot()
        assert snap["signatures"][0]["state"] == "fast"
        assert snap["episodes"][0]["direction"] == "fast"
        assert caps == [] and snap["anomalies_total"] == {"fast": 1}
    finally:
        obs.close()


def test_detector_quiet_below_baseline_floor():
    det = AnomalyDetector(None, clock=_FakeClock())
    clock = det._clock
    _feed(det, clock, "sig", 0.010, 10, 9.0)
    clock.t += 301.0
    _feed(det, clock, "sig", 0.050, 8, 1.0)
    det.evaluate(clock.t)
    assert det.snapshot()["signatures"][0]["state"] == "ok"
    assert det.snapshot()["episodes"] == []


def test_detector_ratio_must_exceed_one():
    with pytest.raises(ValueError):
        AnomalyDetector(None, ratio=1.0)


@pytest.mark.parametrize("walls", [(0.010, 0.050), (0.010, 0.002),
                                   (0.010, 0.011)])
def test_detector_snapshots_equal_the_references(walls):
    """The same feed under the same clock: the same states, episodes and
    ratios as the reference's detector."""
    snaps = []
    for cls in (AnomalyDetector, JaxDetector):
        clock = _FakeClock()
        det = cls(None, clock=clock)
        _feed(det, clock, "sig", walls[0], 40, 9.0)
        clock.t += 301.0
        _feed(det, clock, "sig", walls[1], 16, 1.0, tids=True)
        det.evaluate(clock.t)
        snaps.append(det.snapshot())
    assert snaps[0] == snaps[1]


# ------------------------------------------------ capture duty cycle


def test_capture_cooldown_never_back_to_back(tmp_path):
    obs = Obs()
    clock = _FakeClock()
    caps = []
    try:
        det = AnomalyDetector(obs, clock=clock, profile_dir=str(tmp_path),
                              cooldown_s=1000.0,
                              capture_fn=lambda d, s: caps.append(d))
        _slow_drift(det, clock)
        assert len(caps) == 1
        for expect in (1, 2):
            clock.t += 301.0
            _feed(det, clock, "sig", 0.010, 16, 0.5)
            for _ in range(3):
                det.evaluate(clock.t)
            clock.t += 301.0
            _feed(det, clock, "sig", 0.050, 16, 0.5, tids=True)
            det.evaluate(clock.t)
            assert len(caps) == expect
        snap = det.snapshot()
        assert len(snap["episodes"]) == 3
        assert snap["episodes"][1]["capture_dir"] is None
        assert snap["capture"]["captures"] == 2
    finally:
        obs.close()


def test_capture_retention_prunes_oldest(tmp_path):
    for stale in ("anomaly-20250101-000000-001",
                  "anomaly-20250102-000000-002",
                  "anomaly-20250103-000000-003"):
        os.makedirs(tmp_path / stale)
    det = AnomalyDetector(None, clock=_FakeClock(),
                          profile_dir=str(tmp_path), cooldown_s=0.0,
                          retention=2, capture_fn=lambda d, s: None)
    path = det._maybe_capture(1000.0)
    assert path is not None and os.path.isdir(path)
    left = sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("anomaly-"))
    assert len(left) == 2
    assert os.path.basename(path) in left
    assert "anomaly-20250103-000000-003" in left


def test_capture_disarmed_without_profile_dir():
    caps = []
    obs = Obs()
    clock = _FakeClock()
    try:
        det = AnomalyDetector(obs, clock=clock, profile_dir=None,
                              capture_fn=lambda d, s: caps.append(d))
        _slow_drift(det, clock)
        ep = det.snapshot()["episodes"][0]
        assert ep["direction"] == "slow" and ep["capture_dir"] is None
        assert caps == []
    finally:
        obs.close()


def test_default_capture_is_a_torch_profiler_trace(tmp_path):
    """Without an injected capture, a slow episode captures through
    ``run_profile``: a Chrome trace lands in the rotated directory."""
    import time

    from mpi_tpu_torch.obs import profile

    obs = Obs()
    clock = _FakeClock()
    try:
        det = AnomalyDetector(obs, clock=clock, profile_dir=str(tmp_path),
                              capture_s=0.1)
        _slow_drift(det, clock)
        (d,) = [e["capture_dir"] for e in det.snapshot()["episodes"]]
        t_end = time.monotonic() + 60
        while time.monotonic() < t_end and not (
                os.path.isdir(d) and any(f.endswith(".json")
                                         for f in os.listdir(d))):
            time.sleep(0.05)
        while profile.capturing.is_set() and time.monotonic() < t_end:
            time.sleep(0.05)
        assert any(f.startswith("trace-") for f in os.listdir(d))
    finally:
        obs.close()


# ------------------------------------------------ end to end


def test_e2e_latency_regression_rings_and_captures(tmp_path):
    """A session's steps slow down mid-stream (fault ``step:41+:delay``):
    the detector rings one ``dispatch_anomaly`` with exemplar trace ids,
    arms exactly one capture within the cooldown, and the flight records
    attribute the slow steps — only the clock is injected."""
    obs = Obs()
    clock = _FakeClock(5000.0)
    caps = []
    mgr = SessionManager(EngineCache(max_size=2), obs=obs, batching=False,
                         device="cpu", faults="step:41+:delay:0.03")
    tel = obs.arm_telemetry(interval_s=5.0, manager=mgr, clock=clock,
                            start=False)
    obs.arm_flight(capacity=64, manager=mgr, anomaly=True,
                   profile_dir=str(tmp_path), devmem=False, clock=clock,
                   capture_fn=lambda d, s: caps.append(d))

    def step(sid):
        token = set_trace_context(mint())
        try:
            mgr.step(sid, 1)
        finally:
            reset_trace_context(token)

    try:
        sid = mgr.create({"rows": 16, "cols": 32})["id"]
        for _ in range(40):
            clock.t += 9.0
            step(sid)
        clock.t += 301.0
        for _ in range(16):
            clock.t += 1.0
            step(sid)
        tel.sample_once(clock.t)
        events = [r for r in obs.tracer.snapshot()
                  if r["name"] == "dispatch_anomaly"]
        assert len(events) == 1
        ev = events[0]
        assert ev["direction"] == "slow"
        assert 1 <= len(ev["exemplars"]) <= 3
        assert all(len(t) == 32 for t in ev["exemplars"])
        assert len(caps) == 1 and ev["capture"] == caps[0]
        clock.t += 5.0
        tel.sample_once(clock.t)
        assert len([r for r in obs.tracer.snapshot()
                    if r["name"] == "dispatch_anomaly"]) == 1
        slow = obs.flight.snapshot(slower_than=0.02)
        assert len(slow) == 16
        assert all(r["session"] == sid and r["trace_id"] for r in slow)
        assert set(ev["exemplars"]) <= {r["trace_id"] for r in slow}
        doc = obs.anomaly.snapshot()
        assert doc["anomalies_total"] == {"slow": 1}
        assert doc["capture"]["captures"] == 1
        sig = doc["episodes"][0]["sig"]
        text = obs.render_metrics()
        assert f'mpi_tpu_anomaly_state{{sig="{sig}"}} 2' in text
        assert 'mpi_tpu_dispatch_anomalies_total{direction="slow"} 1' \
            in text
        assert "mpi_tpu_anomaly_captures_total 1" in text
    finally:
        mgr.shutdown()
        obs.close()
