"""The port's multi-tenant admission control (``mpi_tpu_torch.admission``)
on the CPU: the scenarios of the reference's ``tests/test_admission.py``,
its cluster-wide quota included, plus the port's own estimate: the
engine's cost cards (K1-K3's instruction counts) over the roof, which off
the card is the H100 roof this repo measured.

Six contracts:

* tenants-file validation — every error is a ``ConfigError`` naming the
  offending tenant and key (the slo.py discipline), unknown tenants are
  a client error, class overrides clamp at the tenant ceiling;
* quota math in ledger currency — the window holds what the ledger
  *settled* (the post-dispatch hook), the estimate only gates; the
  Retry-After answers exactly when enough settled spend ages out;
* cost-aware scheduling — the dispatcher's class pick is the smooth
  weighted round-robin sequence (4:2:1, interactive > standard > bulk),
  so no class with queued work starves in either direction;
* SLO-driven shedding — the first critical evaluation sheds bulk
  immediately, every further rung (and every release) needs
  ``damp_evals`` consecutive evaluations, interactive survives the
  default ladder;
* enforcement precedes device work — an over-quota step answers 429
  with the unified structured body and never produces a dispatch span
  or a ledger debit;
* default-off purity — an unarmed process registers none of the four
  admission families, its scrape is byte-identical to an armed one's
  shared portion, and its trace stream never mentions admission.

Managers run on the CPU (``device="cpu"``); every manager and server is
shut down by the test that made it.  Where a test needs a round
device-seconds estimate it sets ``MPI_TPU_ROOF_OPS_PER_S``.
"""

import http.client
import json
import threading
import types

import pytest

from mpi_tpu.analysis.obsreg import admission_families
from mpi_tpu_torch.admission import (
    AdmissionControl, QuotaExceeded, ShedRejected,
)
from mpi_tpu_torch.admission.quota import QuotaGate, retry_after_header
from mpi_tpu_torch.admission.sched import WeightedClassPicker
from mpi_tpu_torch.admission.shed import LoadShedder
from mpi_tpu_torch.admission.tenants import (
    TenantRegistry, load_tenants_file, normalize_tenants,
)
from mpi_tpu_torch.cluster import ClusterNode
from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.obs.metrics import FAMILIES
from mpi_tpu_torch.serve.cache import EngineCache
from mpi_tpu_torch.serve.httpd import make_server
from mpi_tpu_torch.serve.session import SessionManager

DISPATCH_SPANS = ("device_dispatch", "batched_dispatch", "host_step")


class _FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(autouse=True)
def _shutdown_managers(monkeypatch):
    """Every manager a test builds is shut down after it (the dispatch
    loop stopped, watchdog workers joined)."""
    made = []
    real = SessionManager.__init__

    def init(self, *a, **kw):
        real(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(SessionManager, "__init__", init)
    yield
    for mgr in made:
        mgr.shutdown()


def _manager(obs=None, specs=None, telemetry=False):
    obs = obs or Obs()
    mgr = SessionManager(EngineCache(max_size=4), batching=False, obs=obs,
                         device="cpu")
    if telemetry:
        obs.arm_telemetry(interval_s=5.0, manager=mgr, start=False)
    adm = None
    if specs is not None:
        adm = AdmissionControl(specs)
        adm.arm(mgr, obs)
    return obs, mgr, adm


class _Node:
    """One in-process serving node: manager + threaded server with an
    armed admission layer."""

    def __init__(self, specs=None, telemetry=False):
        self.obs, self.mgr, self.adm = _manager(specs=specs,
                                                telemetry=telemetry)
        self.srv = make_server("127.0.0.1", 0, self.mgr)
        host, port = self.srv.server_address[:2]
        self.addr = f"{host}:{port}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.node = None

    def join(self, peers):
        self.node = ClusterNode(self.addr, peers, self.mgr,
                                interval_s=3600.0, obs=self.obs)
        self.mgr.attach_cluster(self.node)
        self.srv.core.cluster = self.node
        return self.node

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


def _req(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(addr, timeout=30)
    payload = None if body is None else json.dumps(body)
    conn.request(method, path, body=payload, headers=dict(headers or {}))
    resp = conn.getresponse()
    data = resp.read()
    hdrs = dict(resp.getheaders())
    conn.close()
    try:
        return resp.status, json.loads(data), hdrs
    except (ValueError, UnicodeDecodeError):
        return resp.status, data, hdrs


# ------------------------------------------------ tenants-file validation


def test_tenant_validation_names_the_offending_tenant_and_key():
    cases = [
        ("not-a-dict", "must be an object"),
        ({}, "non-empty string name"),
        ({"name": ""}, "non-empty string name"),
        ({"name": "t", "bogus": 1}, r"t: unknown keys \['bogus'\]"),
        ({"name": "t", "device_s_per_window": -1},
         "t: device_s_per_window must be a positive number"),
        ({"name": "t", "device_s_per_window": True},
         "t: device_s_per_window must be a positive number"),
        ({"name": "t", "cells_per_window": 0},
         "t: cells_per_window must be a positive int"),
        ({"name": "t", "cells_per_window": 1.5},
         "t: cells_per_window must be a positive int"),
        ({"name": "t", "window_s": 0},
         "t: window_s must be a positive number"),
        ({"name": "t", "max_sessions": 0},
         "t: max_sessions must be an int >= 1"),
        ({"name": "t", "max_sessions": True},
         "t: max_sessions must be an int >= 1"),
        ({"name": "t", "default_class": "vip"},
         "t: default_class must be one of"),
        ({"name": "t", "max_class": "vip"}, "t: max_class must be one of"),
        ({"name": "t", "default_class": "interactive",
          "max_class": "bulk"},
         "default_class 'interactive' outranks max_class 'bulk'"),
    ]
    for raw, msg in cases:
        with pytest.raises(ConfigError, match=msg):
            normalize_tenants([raw])
    with pytest.raises(ConfigError, match="duplicate tenant name 'x'"):
        normalize_tenants([{"name": "x"}, {"name": "x"}])
    with pytest.raises(ConfigError, match="unknown top-level keys"):
        normalize_tenants({"tenants": [{"name": "t"}], "bogus": 1})
    with pytest.raises(ConfigError, match="non-empty list"):
        normalize_tenants([])
    with pytest.raises(ConfigError, match="non-empty list"):
        normalize_tenants({"tenants": None})
    # the default tenant is appended when the file omits it, with
    # documented defaults: 60s window, standard class, interactive cap
    specs = normalize_tenants([{"name": "t", "cells_per_window": 5}])
    assert set(specs) == {"t", "default"}
    assert specs["default"]["window_s"] == 60.0
    assert specs["default"]["cells_per_window"] is None
    assert specs["t"]["default_class"] == "standard"
    assert specs["t"]["max_class"] == "interactive"
    # ... and a declared default is honored, not duplicated
    specs = normalize_tenants({"tenants": [
        {"name": "default", "max_sessions": 2}]})
    assert specs["default"]["max_sessions"] == 2


def test_load_tenants_file_errors_and_roundtrip(tmp_path):
    with pytest.raises(ConfigError, match="cannot read tenants file"):
        load_tenants_file(str(tmp_path / "missing.json"))
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    with pytest.raises(ConfigError, match="is not JSON"):
        load_tenants_file(str(bad))
    good = tmp_path / "tenants.json"
    good.write_text(json.dumps({"tenants": [
        {"name": "paying", "device_s_per_window": 1.5, "window_s": 30,
         "max_class": "interactive", "default_class": "interactive"}]}))
    specs = load_tenants_file(str(good))
    assert specs["paying"]["device_s_per_window"] == 1.5
    assert specs["paying"]["window_s"] == 30.0


def test_registry_resolution_and_class_clamping():
    reg = TenantRegistry(normalize_tenants([
        {"name": "bulkish", "default_class": "bulk",
         "max_class": "standard"}]))
    assert reg.resolve(None) == "default"
    assert reg.resolve("") == "default"
    assert reg.resolve("bulkish") == "bulkish"
    with pytest.raises(ConfigError, match="unknown tenant 'ghost'"):
        reg.resolve("ghost")
    # no ask -> tenant default; an ask above the ceiling is capped (not
    # rejected); an unknown class name is a client error
    assert reg.resolve_class("bulkish", None) == "bulk"
    assert reg.resolve_class("bulkish", "interactive") == "standard"
    assert reg.resolve_class("bulkish", "bulk") == "bulk"
    assert reg.resolve_class("default", "interactive") == "interactive"
    with pytest.raises(ConfigError, match="unknown priority class 'vip'"):
        reg.resolve_class("default", "vip")


# ------------------------------------------------ weighted class picker


def test_picker_smooth_weighted_round_robin_sequence():
    p = WeightedClassPicker()
    all3 = ["interactive", "standard", "bulk"]
    seq = [p.pick(all3) for _ in range(7)]
    # the canonical smooth-WRR 4:2:1 interleave: interactive never waits
    # more than one round, bulk is served exactly once per cycle
    assert seq == ["interactive", "standard", "interactive", "bulk",
                   "interactive", "standard", "interactive"]
    p.reset()
    picks = [p.pick(all3) for _ in range(28)]
    assert picks.count("interactive") == 16
    assert picks.count("standard") == 8
    assert picks.count("bulk") == 4
    # a single waiting class short-circuits; an empty round is a bug
    assert p.pick(["bulk"]) == "bulk"
    with pytest.raises(ValueError, match="at least one waiting class"):
        p.pick([])
    # an idle class banks no credit: after rounds without interactive,
    # its first appearance still wins only by weight, not by backlog
    p.reset()
    assert p.pick(["standard", "bulk"]) == "standard"
    assert p.pick(["standard", "bulk"]) == "bulk"
    assert p.pick(all3) == "interactive"


def test_dispatcher_serves_classes_in_picker_order_no_starvation():
    """Seven queued tickets across three classes drain in exactly the
    smooth-WRR order — interactive dominates 4:2:1 but bulk still gets
    its round (neither direction starves).  The loop thread is stubbed
    out and ``_run_round`` driven by hand, so the order is the
    scheduler's, not the OS's."""
    obs, mgr, adm = _manager(specs=normalize_tenants([{"name": "t"}]))
    disp = mgr.dispatcher
    # pre-start sentinel: submit() must not spin up the real loop
    stub = threading.Thread(target=lambda: None)
    stub.start()
    stub.join()
    disp._thread = stub
    sids = {}
    for cls in ("interactive", "standard", "bulk"):
        sids[cls] = mgr.create({"rows": 8, "cols": 8, "backend": "serial"},
                               tenant="t")["id"]
    tickets = []
    for cls, n in (("interactive", 4), ("standard", 2), ("bulk", 1)):
        for _ in range(n):
            tid = mgr.step_async(sids[cls], 1, qos=cls)["ticket"]
            tickets.append(disp.get(tid))
    assert disp.queue_depth() == 7
    with disp._cv:             # the loop's inbox -> per-session transfer
        inbox, disp._inbox = disp._inbox, []
        for t in inbox:
            disp._per_session.setdefault(t.sid, []).append(t)
    assert disp.depth_by_class() == {"interactive": 4, "standard": 2,
                                     "bulk": 1}
    order = []
    for _ in range(7):
        before = {t.id for t in tickets if t.status != "pending"}
        disp._run_round()
        done = [t for t in tickets
                if t.status != "pending" and t.id not in before]
        assert len(done) == 1   # one head per class -> one per round
        order.append(done[0].qos)
    assert order == ["interactive", "standard", "interactive", "bulk",
                     "interactive", "standard", "interactive"]
    assert all(t.status == "done" for t in tickets)
    assert mgr.get(sids["bulk"]).generation == 1


# ------------------------------------------------ shed ladder


def test_shed_ladder_first_critical_immediate_then_damped():
    sh = LoadShedder(damp_evals=3, max_level=2)
    assert sh.evaluate("ok") == 0
    # worsening is immediate (the slo.py discipline): first critical
    # sheds bulk right away ...
    assert sh.evaluate("critical") == 1
    assert sh.sheds("bulk") and not sh.sheds("standard")
    # ... but the next rung needs damp_evals consecutive criticals
    assert sh.evaluate("critical") == 1
    assert sh.evaluate("critical") == 1
    assert sh.evaluate("critical") == 2
    assert sh.sheds("standard") and not sh.sheds("interactive")
    # max_level=2 (the default) protects interactive from automation
    for _ in range(6):
        assert sh.evaluate("critical") == 2
    # release is damped the same way, one rung per damp window
    assert sh.evaluate("ok") == 2
    assert sh.evaluate("warning") == 2
    assert sh.evaluate("ok") == 1
    assert sh.evaluate("ok") == 1
    assert sh.evaluate("ok") == 1
    assert sh.evaluate("ok") == 0
    assert sh.transitions == 4
    # a flapping window cannot ratchet: critical resets the clear
    # streak and vice versa
    sh2 = LoadShedder(damp_evals=3, max_level=2)
    sh2.evaluate("critical")
    for _ in range(4):
        sh2.evaluate("critical")
        sh2.evaluate("ok")
    assert sh2.level == 1


def test_shed_check_shape_and_full_ladder_when_allowed():
    sh = LoadShedder(damp_evals=1, max_level=3, retry_after_s=12.0)
    for lvl in (1, 2, 3):
        assert sh.evaluate("critical") == lvl
    assert sh.sheds("interactive")
    with pytest.raises(ShedRejected, match="shed level 3") as ei:
        sh.check("t", "interactive")
    assert ei.value.tenant == "t"
    assert ei.value.retry_after_s == 12.0


# ------------------------------------------------ quota window math


def test_quota_retry_after_is_the_window_refill_instant():
    clock = _FakeClock(0.0)
    reg = TenantRegistry(normalize_tenants(
        [{"name": "t", "cells_per_window": 100}]))   # 60s window
    gate = QuotaGate(reg, clock=clock)
    gate.charge("t", 0.0, 50)
    clock.t = 10.0
    gate.charge("t", 0.0, 40)
    clock.t = 20.0
    assert gate.spent("t") == (0.0, 90)
    # overshoot of 20 cells: the t=0 charge (50 cells) covers it, and
    # leaves the window at t=60 -> 40s from now
    with pytest.raises(QuotaExceeded, match=r"90 spent \+ 30 estimated "
                                            r"> 100 per 60s window") as ei:
        gate.admit("t", 0.0, 30)
    assert ei.value.retry_after_s == 40.0
    assert retry_after_header(ei.value.retry_after_s) == ("Retry-After",
                                                          "40")
    # overshoot of 70: both charges must age out, gated by the t=10 one
    with pytest.raises(QuotaExceeded) as ei:
        gate.admit("t", 0.0, 80)
    assert ei.value.retry_after_s == 50.0
    # an estimate bigger than local history can ever free: the honest
    # answer is a full window
    with pytest.raises(QuotaExceeded) as ei:
        gate.admit("t", 0.0, 250)
    assert ei.value.retry_after_s == 60.0
    # sliding, not fixed: once the t=0 charge ages out the same ask fits
    clock.t = 61.0
    assert gate.spent("t") == (0.0, 40)
    gate.admit("t", 0.0, 30)    # no raise
    # Retry-After is integral seconds, never below 1
    assert retry_after_header(0.2) == ("Retry-After", "1")
    assert retry_after_header(40.001) == ("Retry-After", "41")


def test_quota_device_seconds_dimension_and_unlimited_default():
    clock = _FakeClock(0.0)
    reg = TenantRegistry(normalize_tenants(
        [{"name": "t", "device_s_per_window": 1.0, "window_s": 10.0}]))
    gate = QuotaGate(reg, clock=clock)
    gate.charge("t", 0.9, 1000)
    with pytest.raises(QuotaExceeded,
                       match="over device-seconds quota") as ei:
        gate.admit("t", 0.2, 10)
    assert ei.value.retry_after_s == 10.0
    gate.admit("t", 0.05, 10)   # fits under the cap
    # the default tenant is unlimited: any estimate admits
    gate.charge("default", 1e6, 10**12)
    gate.admit("default", 1e6, 10**12)


# ------------------------------------------------ settlement == the books


def test_quota_debit_matches_ledger_settlement_exactly():
    """The window holds what the ledger settled, to the cell: a serial
    (host-kind) step charges cells but zero device-seconds, and the
    settled spend is what gates the next request — the estimate never
    enters the books."""
    obs, mgr, adm = _manager(specs=normalize_tenants(
        [{"name": "t", "cells_per_window": 200}]))
    sid = mgr.create({"rows": 8, "cols": 8, "backend": "serial"},
                     tenant="t")["id"]
    assert adm.gate.tenant_of(sid) == "t"
    # estimate for 3 steps: 192 cells, under the 200 window -> admit
    assert mgr.admission_check(sid, 3) == "standard"
    mgr.step(sid, 3)
    row = obs.ledger.session_row(sid)
    assert row["cells"] == 192
    # host work settles cells but not device time (the quota currency)
    assert adm.gate.spent("t") == (0.0, 192)
    # the settled 192 now gates: one more 64-cell step busts the window
    with pytest.raises(QuotaExceeded,
                       match=r"192 spent \+ 64 estimated > 200"):
        mgr.admission_check(sid, 1)
    blk = mgr.usage()["tenants"]
    assert blk["shed_level"] == 0
    t = blk["by_tenant"]["t"]
    assert t["cells"] == 192 and t["cells_per_window"] == 200
    assert t["sessions"] == 1 and t["class_mix"] == {"standard": 1}
    assert t["decisions"] == {"admit": 2, "quota": 1}  # create+step, reject
    # closing the session releases attribution but never refunds spend
    mgr.close(sid)
    assert adm.gate.tenant_of(sid) is None
    assert adm.gate.spent("t") == (0.0, 192)


def test_estimate_vs_settle_reconciliation_on_a_device_engine(monkeypatch):
    """Card-engine sessions settle real device-seconds; the gate's books
    equal the ledger row to the float, and the pre-dispatch estimate is
    the kernel's cost card over the roof: K1's ``word_ops`` per word per
    generation, times words and steps, over ``MPI_TPU_ROOF_OPS_PER_S``
    (set here for a round figure), live from the first
    request (the engine's warm-up captures the depth-1 card)."""
    from mpi_tpu_torch.models.rules import LIFE
    from mpi_tpu_torch.ops.bitlife import word_ops

    monkeypatch.setenv("MPI_TPU_ROOF_OPS_PER_S", "1e9")
    obs, mgr, adm = _manager(specs=normalize_tenants([{"name": "t"}]))
    sid = mgr.create({"rows": 16, "cols": 64, "backend": "cuda",
                      "seed": 3}, tenant="t")["id"]
    session = mgr.get(sid)
    expect_ops = float(word_ops(LIFE)) * 16 * 2 * 2     # 2 words a row
    assert adm.estimate_ops(session, 2) == expect_ops
    est0 = adm.estimate(session, 2)
    assert est0 == (expect_ops / 1e9, 2048)
    mgr.step(sid, 2)
    row = obs.ledger.session_row(sid)
    device_s, cells = adm.gate.spent("t")
    assert cells == row["cells"] == 2048
    assert device_s == pytest.approx(row["device_s"], rel=1e-9, abs=1e-12)
    assert device_s > 0.0
    # post-step: the estimate is the same card arithmetic
    assert session.engine.cost_cards()
    est_device_s, est_cells = adm.estimate(session, 2)
    assert est_device_s == expect_ops / 1e9 and est_cells == 2048
    # settlement went through the ledger hook, not the estimate: the
    # books moved by the settled figure even though no admission
    # decision ran for this direct mgr.step call
    assert adm.gate.spent("t")[1] == 2048


@pytest.mark.parametrize("backend,rule,kernel", [
    ("cuda", "life", "bit"), ("cuda", "bosco", "ltl"),
    ("cuda", "bosco", "dense"),
])
def test_estimate_from_each_kernels_card_over_the_roof(monkeypatch, backend,
                                                      rule, kernel):
    """The estimate of K1, K3 and K2 sessions is their own card's
    instructions per cell times cells and steps, over the roof."""
    monkeypatch.setenv("MPI_TPU_ROOF_OPS_PER_S", "2.5e12")
    obs, mgr, adm = _manager(specs=normalize_tenants([{"name": "t"}]))
    spec = {"rows": 32, "cols": 64, "backend": backend, "rule": rule}
    if kernel == "dense":
        spec["comm_every"] = 3
    sid = mgr.create(spec, tenant="t")["id"]
    session = mgr.get(sid)
    assert session.engine.kind == kernel
    cards = session.engine.cost_cards()
    card = min((c for c in cards if c.depth == 1 and c.flops > 0),
               key=lambda c: c.ops_per_cell(2048))
    ops = card.ops_per_cell(2048) * 2048 * 5
    assert adm.estimate_ops(session, 5) == pytest.approx(ops, rel=1e-12)
    est_s, est_cells = adm.estimate(session, 5)
    assert est_s == pytest.approx(ops / 2.5e12, rel=1e-12)
    assert est_cells == 5 * 2048


def test_no_roof_estimates_zero_device_seconds_and_admits(monkeypatch):
    """Off the card with ``MPI_TPU_ROOF_OPS_PER_S`` unset the roof is
    the H100's measured one (``DEFAULT_ROOF_OPS_PER_S``; no TPU figure
    is carried over), so the estimate is never a silent 0 any more: it
    is the card's instructions over that roof, a tenant with a tiny
    device-seconds quota is refused (no TypeError), and one with room
    is admitted and steps."""
    monkeypatch.delenv("MPI_TPU_ROOF_OPS_PER_S", raising=False)
    from mpi_tpu_torch.obs.cost import DEFAULT_ROOF_OPS_PER_S, roof_ops_per_s

    assert roof_ops_per_s() == DEFAULT_ROOF_OPS_PER_S == 132 * 64 * 1.98e9
    obs, mgr, adm = _manager(specs=normalize_tenants(
        [{"name": "t", "device_s_per_window": 1e-12},
         {"name": "roomy"}]))
    sid = mgr.create({"rows": 16, "cols": 64, "backend": "cuda"},
                     tenant="t")["id"]
    session = mgr.get(sid)
    ops = adm.estimate_ops(session, 4)
    assert ops > 0.0
    assert adm.estimate(session, 4) == (ops / DEFAULT_ROOF_OPS_PER_S,
                                        4 * 1024)
    with pytest.raises(QuotaExceeded):
        mgr.admission_check(sid, 4)
    assert mgr.get(sid).generation == 0
    sid2 = mgr.create({"rows": 16, "cols": 64, "backend": "cuda"},
                      tenant="roomy")["id"]
    assert mgr.admission_check(sid2, 4) == "standard"
    mgr.step(sid2, 4)
    assert mgr.get(sid2).generation == 4


def test_session_caps_gate_create_and_release_on_close():
    obs, mgr, adm = _manager(specs=normalize_tenants(
        [{"name": "t", "max_sessions": 1, "window_s": 45.0}]))
    spec = {"rows": 8, "cols": 8, "backend": "serial"}
    sid = mgr.create(spec, tenant="t")["id"]
    with pytest.raises(QuotaExceeded,
                       match=r"at max_sessions \(1 live, cap 1\)") as ei:
        mgr.create(spec, tenant="t")
    assert ei.value.retry_after_s == 45.0
    assert adm._decisions[("t", "quota")] == 1
    # the default tenant is not capped by t's spec
    mgr.create(spec)
    # closing frees the slot
    mgr.close(sid)
    mgr.create(spec, tenant="t")


# ------------------------------------------------ HTTP seam (armed)


def test_over_quota_429_shape_and_no_device_work(tmp_path):
    n = _Node(specs=normalize_tenants(
        [{"name": "capped", "cells_per_window": 64}]))
    try:
        st, doc, _ = _req(n.addr, "POST", "/sessions",
                          {"rows": 16, "cols": 16, "backend": "cuda"},
                          headers={"X-Gol-Tenant": "capped"})
        assert st == 200
        sid = doc["id"]
        # 256 cells estimated vs a 64-cell window: rejected on the very
        # first step, before any device work
        st, err, hdrs = _req(n.addr, "POST", f"/sessions/{sid}/step",
                             {"steps": 1},
                             headers={"X-Gol-Tenant": "capped"})
        assert st == 429
        assert set(err) == {"error", "tenant", "request_id", "trace_id"}
        assert err["tenant"] == "capped"
        assert "over cells quota" in err["error"]
        # no local history to age out -> Retry-After is the full window
        assert hdrs["Retry-After"] == "60"
        # enforcement preceded device work: no dispatch span for the
        # session, no ledger debit, zero settled spend
        spans = [r for r in n.obs.tracer.snapshot()
                 if r.get("sid") == sid and r["name"] in DISPATCH_SPANS]
        assert spans == []
        assert n.obs.ledger.session_row(sid) is None
        assert n.adm.gate.spent("capped") == (0.0, 0)
        # the rejection is observable: a trace event + labeled counter
        recs = [r for r in n.obs.tracer.snapshot()
                if r["name"] == "admission_reject"]
        assert recs and recs[-1]["decision"] == "quota"
        assert recs[-1]["tenant"] == "capped"
        scrape = n.obs.render_metrics()
        assert ('mpi_tpu_admission_decisions_total'
                '{decision="quota",tenant="capped"} 1') in scrape
        # an unknown tenant header is a client error, not a quota event
        st, err, _ = _req(n.addr, "POST", "/sessions",
                          {"rows": 8, "cols": 8, "backend": "serial"},
                          headers={"X-Gol-Tenant": "ghost"})
        assert st == 400 and "unknown tenant 'ghost'" in err["error"]
        # a step claiming another registered tenant's session: 400 too
        st, err, _ = _req(n.addr, "POST", f"/sessions/{sid}/step",
                          {"steps": 1},
                          headers={"X-Gol-Tenant": "default"})
        assert st == 400 and "belongs to tenant 'capped'" in err["error"]
    finally:
        n.close()


def test_critical_slo_sheds_bulk_while_interactive_completes():
    n = _Node(specs=normalize_tenants([{"name": "t"}]), telemetry=True)
    try:
        st, doc, _ = _req(n.addr, "POST", "/sessions",
                          {"rows": 8, "cols": 8, "backend": "serial"},
                          headers={"X-Gol-Tenant": "t"})
        assert st == 200
        sid = doc["id"]
        # force the availability SLO critical: the engine's listener
        # chain drives the shedder to level 1 (bulk sheds immediately)
        n.obs.telemetry.sample_once()
        n.obs.http_requests.inc(30, method="POST", path="/step",
                                code="500")
        n.obs.telemetry.sample_once()
        assert n.obs.slo.worst() == "critical"
        assert n.adm.shedder.level == 1
        st, err, hdrs = _req(n.addr, "POST", f"/sessions/{sid}/step",
                             {"steps": 1},
                             headers={"X-Gol-Tenant": "t",
                                      "X-Gol-Class": "bulk"})
        assert st == 429 and "shedding 'bulk'" in err["error"]
        assert int(hdrs["Retry-After"]) >= 1
        recs = [r for r in n.obs.tracer.snapshot()
                if r["name"] == "admission_reject"]
        assert recs[-1]["decision"] == "shed" and recs[-1]["qos"] == "bulk"
        # interactive (and the standard default) ride through level 1
        for cls in ("interactive", None):
            h = {"X-Gol-Tenant": "t"}
            if cls:
                h["X-Gol-Class"] = cls
            st, doc, _ = _req(n.addr, "POST", f"/sessions/{sid}/step",
                              {"steps": 1}, headers=h)
            assert st == 200
        assert n.mgr.get(sid).generation == 2
        assert 'mpi_tpu_shed_level 1' in n.obs.render_metrics()
        # damped release: three clear evaluations re-admit bulk
        for _ in range(3):
            n.adm.shedder.evaluate("ok")
        assert n.adm.shedder.level == 0
        st, _, _ = _req(n.addr, "POST", f"/sessions/{sid}/step",
                        {"steps": 1}, headers={"X-Gol-Tenant": "t",
                                               "X-Gol-Class": "bulk"})
        assert st == 200
    finally:
        n.close()


# ------------------------------------------------ default-off purity


def _drive(obs):
    obs.http_requests.inc(method="GET", path="/x", code="200")
    obs.http_requests.inc(method="POST", path="/step", code="500")
    obs.dispatch_solo.observe(0.01)
    with obs.span("outer", kind="test"):
        obs.event("evt", foo=1)


def test_unarmed_scrape_is_the_armed_scrape_minus_admission_families():
    fams = admission_families()
    assert len(fams) == 4 and tuple(fams) == FAMILIES["admission"]
    unarmed, armed = Obs(), Obs()
    AdmissionControl().arm(types.SimpleNamespace(obs=None,
                                                 dispatcher=None), armed)
    _drive(unarmed)
    _drive(armed)

    def shared(text):
        return [ln for ln in text.splitlines()
                if not any(f in ln for f in fams)]

    u, a = unarmed.render_metrics(), armed.render_metrics()
    assert shared(u) == u.splitlines()   # nothing to strip unarmed
    for fam in fams:
        assert fam not in u and fam in a
    # stripping exactly the four families off the armed scrape leaves
    # the unarmed text byte-identical, same line order
    assert shared(a) == u.splitlines()
    # the unarmed trace stream never mentions admission
    u_jsonl = "\n".join(json.dumps(r, sort_keys=True)
                        for r in unarmed.tracer.snapshot())
    assert "admission" not in u_jsonl and "tenant" not in u_jsonl


def test_unarmed_manager_has_no_admission_surface():
    obs, mgr, _ = _manager()
    assert mgr.admission is None
    sid = mgr.create({"rows": 8, "cols": 8, "backend": "serial"})["id"]
    # the admission seam is a no-op, not a default-tenant charge
    assert mgr.admission_check(sid, 1, qos="interactive") is None
    mgr.step(sid, 2)
    assert "tenants" not in mgr.usage()
    assert mgr.get(sid).tenant is None and mgr.get(sid).qos is None
    scrape = obs.render_metrics()
    for fam in admission_families():
        assert fam not in scrape
    # async tickets default to standard without banking any admission
    # state (depth_by_class is the gauge's only consumer)
    assert mgr.dispatcher.depth_by_class() == {}


# ------------------------------------------------ cluster-wide quotas


def test_cluster_quota_counts_gossiped_remote_spend():
    """Tenant 'capped' spends its whole 432-cell window on node a; after
    one gossip exchange node b rejects the tenant's next step with zero
    local spend — the only way the math works is the gossiped snapshot.
    Session caps are cluster-wide the same way."""
    specs = normalize_tenants([
        {"name": "capped", "cells_per_window": 432, "window_s": 300.0},
        {"name": "solo", "max_sessions": 1}])
    a, b = _Node(specs=specs), _Node(specs=specs)
    try:
        a.join([b.addr])
        b.join([a.addr])
        spec = {"rows": 12, "cols": 12, "backend": "serial"}
        sid_a = a.mgr.create(spec, tenant="capped")["id"]
        a.mgr.step(sid_a, 3)                 # 3 x 144 = the whole window
        assert a.adm.gate.spent("capped") == (0.0, 432)
        a.mgr.create(spec, tenant="solo")
        b.node.gossip_now()                  # b now holds a's snapshot
        assert b.node.tenant_spend("capped") == (0.0, 432, 1)
        # b's own books are empty, yet the admit must reject: the spent
        # figure in the message is the cluster-wide sum
        assert b.adm.gate.spent("capped") == (0.0, 0)
        sid_b = b.mgr.create(spec, tenant="capped")["id"]
        with pytest.raises(QuotaExceeded,
                           match=r"432 spent \+ 144 estimated > 432"):
            b.mgr.admission_check(sid_b, 1)
        # local history cannot free remote spend: honest full window
        try:
            b.mgr.admission_check(sid_b, 1)
        except QuotaExceeded as e:
            assert e.retry_after_s == 300.0
        # the session cap counts a's live session too
        with pytest.raises(QuotaExceeded,
                           match=r"at max_sessions \(1 live, cap 1\)"):
            b.mgr.create(spec, tenant="solo")
        # a session the gossip hasn't carried yet is still local-only:
        # the unlimited default tenant is unaffected throughout
        b.mgr.create(spec)
        # /usage on b shows b's LOCAL books (the roll-up is the
        # cluster block's job; quota decisions are where the cluster
        # sum applies)
        st, usage, _ = _req(b.addr, "GET", "/usage")
        assert st == 200
        assert usage["tenants"]["by_tenant"]["capped"]["cells"] == 0
        assert usage["tenants"]["by_tenant"]["capped"]["decisions"][
            "quota"] == 2
    finally:
        a.close()
        b.close()
