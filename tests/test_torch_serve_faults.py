"""The port's fault tolerance on the CPU: the fault-injection DSL
(``serve/faults.py``, the reference's copy), retry/backoff, the
per-signature circuit breaker, degradation to the ``serial_np`` oracle
(bit-identical by construction: it IS the oracle), the dispatch watchdog
and the deep health payload — the reference's ``tests/test_serve_faults.py``
scenarios that need no network front, against ``SessionManager(device=
"cpu")``.  Failures come from injected faults, and a hung step's worker is
joined, not waited out with a sleep."""

import time

import numpy as np
import pytest

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.models.rules import LIFE
from mpi_tpu.serve.faults import FaultInjector as JaxFaultInjector
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.serve import (
    DeadlineError,
    EngineCache,
    EngineStepError,
    EngineUnavailableError,
    FaultInjector,
    FaultPlan,
    InjectedFault,
    SessionManager,
)
from mpi_tpu_torch.serve.faults import InjectedNetworkFault

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
        assert not mgr._workers


def _drain(mgr):
    """Wait for the manager's abandoned watchdog workers to finish."""
    for t in list(mgr._workers):
        t.join(timeout=60)
        assert not t.is_alive()


def _oracle(rows, cols, seed, steps, boundary="periodic", rule=LIFE):
    return evolve_np(init_tile_np(rows, cols, seed), steps, rule, boundary)


def _board(mgr, sid):
    return mgr.snapshot_array(sid)[0]


# ------------------------------------------------------------ fault DSL


def test_fault_plan_parses_the_grammar():
    p = FaultPlan.parse("seed=7,step:3:raise,batched:2-4:hang:1.5,"
                        "any:p0.25:delay")
    assert p.seed == 7 and len(p.clauses) == 3
    one, rng, prob = p.clauses
    assert (one.site, one.lo, one.hi, one.mode) == ("step", 3, 3, "raise")
    assert (rng.site, rng.lo, rng.hi, rng.seconds) == ("batched", 2, 4, 1.5)
    assert (prob.site, prob.prob, prob.seconds) == ("any", 0.25, 0.05)
    assert FaultPlan.parse("step:5+:raise").clauses[0].hi is None
    assert FaultPlan.parse("any:*:delay:0").clauses[0].lo is None


@pytest.mark.parametrize("bad", [
    "", "step:1", "disk:1:raise", "step:1:explode", "step:0:raise",
    "step:-1:raise", "step:p2:raise", "step:1:hang:-3", "seed=x,step:1:raise",
    "step:one:raise", "gossip:1:raise", "proxy:1:hang", "step:1:drop",
    "any:1:partition", "network:1:drop", "io-write:1:hang",
    "io-fsync:1:torn:1.5",
])
def test_fault_plan_rejects_bad_specs(bad):
    with pytest.raises(ConfigError):
        FaultPlan.parse(bad)


def test_injector_fires_on_the_nth_dispatch_only():
    inj = FaultInjector.from_spec("step:2:raise")
    inj.engine_hook("step")
    with pytest.raises(InjectedFault):
        inj.engine_hook("step")
    inj.engine_hook("step")
    assert inj.stats()["injected"]["raise"] == 1
    assert inj.stats()["dispatches"]["step"] == 3


def test_injector_any_site_counts_both_streams():
    inj = FaultInjector.from_spec("any:3:raise")
    inj.engine_hook("step")
    inj.engine_hook("batched")
    with pytest.raises(InjectedFault):
        inj.engine_hook("step")


def test_injector_fires_as_the_references_does():
    """Same spec and seed, same sites in the same order: the same
    dispatches fail in the port's injector and the reference's."""
    spec = "seed=11,step:p0.5:raise,batched:3-5:raise,io-write:2:enospc"
    pattern = []
    for cls in (FaultInjector, JaxFaultInjector):
        inj, out = cls.from_spec(spec), []
        for i in range(30):
            site = ("step", "batched", "io-write")[i % 3]
            try:
                (inj.io_hook if site == "io-write" else inj.engine_hook)(site)
                out.append(0)
            except (RuntimeError, OSError):
                out.append(1)
        pattern.append((out, inj.stats()))
    assert pattern[0] == pattern[1]
    assert 0 < sum(pattern[0][0]) < 30


def test_injector_delay_mode_proceeds():
    inj = FaultInjector.from_spec("step:1:delay:0.01")
    t0 = time.perf_counter()
    inj.engine_hook("step")
    assert time.perf_counter() - t0 >= 0.01
    assert inj.stats()["injected"]["delay"] == 1


def test_net_hook_and_inbound_cut():
    inj = FaultInjector.from_spec("gossip:2-3:partition,proxy:1:drop")
    assert not inj.inbound_cut("gossip")
    inj.net_hook("gossip", "h1:8000")
    assert inj.inbound_cut("gossip") and not inj.inbound_cut("proxy")
    for _ in range(2):
        with pytest.raises(InjectedNetworkFault):
            inj.net_hook("gossip")
    assert not inj.inbound_cut("gossip")
    with pytest.raises(InjectedNetworkFault):
        inj.net_hook("proxy")
    assert not issubclass(InjectedNetworkFault, InjectedFault)


# ------------------------------------------------------ retry + breaker


def test_injected_fault_leaves_the_grid_intact():
    """The hook runs before the step takes a buffer: the caller's grid
    is untouched by a failed step, and the retry steps it."""
    from mpi_tpu_torch.backends.cuda import build_engine
    from mpi_tpu_torch.config import GolConfig

    eng = build_engine(GolConfig(rows=32, cols=64, steps=0, seed=4), "cpu")
    eng.fault_hook = FaultInjector.from_spec("step:1:raise").engine_hook
    grid = eng.init_grid()
    before = eng.fetch(grid)
    spares = dict(eng._spares)
    with pytest.raises(InjectedFault):
        eng.step(grid, 3)
    assert np.array_equal(eng.fetch(grid), before)
    assert eng._spares == spares and eng.step_calls == 0
    assert np.array_equal(eng.fetch(eng.step(grid, 3)),
                          _oracle(32, 64, 4, 3))


def test_transient_fault_retries_and_succeeds(make_manager):
    mgr = make_manager(EngineCache(max_size=4), step_retries=2,
                       retry_backoff_s=0.001, faults="step:1:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=31))["id"]
    r = mgr.step(sid, 1)
    assert r["generation"] == 1 and mgr.engine_failures == 1
    st = mgr.stats()
    assert st["breaker"]["open"] == []
    assert st["breaker"]["consecutive_failures"] == 0
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 31, 1))
    assert "last_error" in mgr.describe(mgr.get(sid))


def test_retries_exhausted_without_trip_is_recoverable(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=5)
    mgr = make_manager(cache, step_retries=1, retry_backoff_s=0.001,
                       faults="step:1-2:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=33))["id"]
    with pytest.raises(EngineStepError):
        mgr.step(sid, 1)
    s = mgr.get(sid)
    assert not s.degraded and s.generation == 0
    assert mgr.step(sid, 1)["generation"] == 1
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 33, 1))


@pytest.mark.parametrize("spec", [
    dict(CUDA_SPEC), dict(rows=40, cols=50, rule="bosco", comm_every=3)],
    ids=["k1", "k2"])
def test_breaker_trips_and_session_degrades_with_parity(make_manager, spec):
    cache = EngineCache(max_size=4, breaker_threshold=3,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=2, retry_backoff_s=0.001,
                       faults="step:1-3:raise")
    sid = mgr.create(dict(spec, seed=41))["id"]
    mgr.step(sid, 2)                    # 1 committed step, no fault yet
    r = mgr.step(sid, 1)                # 3 failures -> breaker -> degrade
    assert r["generation"] == 3
    s = mgr.get(sid)
    assert s.degraded and s.engine is None
    rule = "bosco" if spec.get("rule") else "life"
    from mpi_tpu.models.rules import rule_from_name

    def ref(n):
        return _oracle(spec["rows"], spec["cols"], 41, n,
                       rule=rule_from_name(rule))

    assert np.array_equal(_board(mgr, sid), ref(3))
    mgr.step(sid, 3)
    assert np.array_equal(_board(mgr, sid), ref(6))
    d = mgr.describe(s)
    assert d["degraded"] and d["active_backend"] == "serial_np"
    st = mgr.stats()
    assert len(st["breaker"]["open"]) == 1 and st["breaker"]["trips"] == 1
    assert st["failures"]["degraded_sessions"] == 1
    assert st["failures"]["degraded_total"] == 1
    assert st["faults"]["injected"]["raise"] == 3
    h = mgr.health()
    assert h["ok"] and h["degraded_sessions"] == 1


def test_create_on_open_breaker_is_degraded_from_birth(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=3,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=2, retry_backoff_s=0.001,
                       faults="step:1-3:raise")
    a = mgr.create(dict(CUDA_SPEC, seed=43))["id"]
    mgr.step(a, 1)
    b = mgr.create(dict(CUDA_SPEC, seed=44))
    assert b["degraded"] is True
    mgr.step(b["id"], 2)
    assert np.array_equal(_board(mgr, b["id"]), _oracle(64, 64, 44, 2))


def test_no_degrade_answers_unavailable_and_health_degrades(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=3, retry_backoff_s=0.001,
                       degrade=False, faults="step:1-2:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=47))["id"]
    with pytest.raises(EngineUnavailableError):
        mgr.step(sid, 1)
    s = mgr.get(sid)
    assert not s.degraded and s.engine is not None and s.generation == 0
    assert mgr.health()["ok"] is False
    with pytest.raises(EngineUnavailableError):
        mgr.create(dict(CUDA_SPEC, seed=48))


@pytest.mark.parametrize("card,injected", [
    (True, True), (True, False), (False, False)],
    ids=["card-injected", "card-real", "cpu-real"])
def test_only_an_injected_fault_degrades_a_card_session(make_manager, card,
                                                        injected):
    """On the card a session moves to the host oracle only after injected
    faults; a real failure of its engine opens the breaker and answers
    EngineUnavailableError, the session staying on its engine.  On the CPU
    any failure degrades, as the reference's sessions do.  The CPU
    manager takes the card's rule through ``_on_card``; the engine's
    fault hook raises the failure before any launch."""
    cache = EngineCache(max_size=4, breaker_threshold=3,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=2, retry_backoff_s=0.001,
                       batching=False)
    mgr._on_card = card
    sid = mgr.create(dict(CUDA_SPEC, seed=53))["id"]
    err = InjectedFault if injected else RuntimeError

    def hook(site):
        raise err(f"{site} dispatch failed")

    mgr.get(sid).engine.fault_hook = hook
    if card and not injected:
        with pytest.raises(EngineUnavailableError, match="card"):
            mgr.step(sid, 1)
        s = mgr.get(sid)
        assert not s.degraded and s.engine is not None and s.generation == 0
        assert mgr.degraded_total == 0 and mgr.engine_failures == 3
        assert mgr.health()["ok"] is False
        with pytest.raises(EngineUnavailableError, match="card"):
            mgr.create(dict(CUDA_SPEC, seed=54))
        return
    assert mgr.step(sid, 1)["generation"] == 1
    s = mgr.get(sid)
    assert s.degraded and s.engine is None and mgr.degraded_total == 1
    assert mgr.health()["ok"] is True
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 53, 1))


def test_breaker_half_open_trial_recovers(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=0.05)
    mgr = make_manager(cache, step_retries=1, retry_backoff_s=0.001,
                       degrade=False, faults="step:1-2:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=51))["id"]
    with pytest.raises(EngineUnavailableError):
        mgr.step(sid, 1)
    time.sleep(0.06)                    # cooldown -> half-open
    assert cache.breaker_stats()["half_open"]
    assert mgr.step(sid, 1)["generation"] == 1
    assert cache.breaker_stats()["open"] == []
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 51, 1))


# --------------------------------------------------- watchdog deadlines


def test_hung_dispatch_is_a_deadline_and_the_session_survives(make_manager):
    mgr = make_manager(EngineCache(max_size=4), request_timeout_s=0.3,
                       step_retries=0, faults="step:1:hang:1.0")
    sid = mgr.create(dict(CUDA_SPEC, seed=53))["id"]
    with pytest.raises(DeadlineError):
        mgr.step(sid, 1)
    assert mgr.watchdog_timeouts == 1
    _drain(mgr)
    assert mgr.step(sid, 1)["generation"] == 1
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 53, 1))


def test_wedged_board_times_out_other_verbs_cleanly(make_manager):
    mgr = make_manager(EngineCache(max_size=4), request_timeout_s=0.25,
                       step_retries=0, faults="step:1:hang:3.0")
    sid = mgr.create(dict(CUDA_SPEC, seed=57))["id"]
    with pytest.raises(DeadlineError):
        mgr.step(sid, 1)
    with pytest.raises(DeadlineError):
        mgr.snapshot(sid)               # the lock is held: its own deadline
    _drain(mgr)
    assert mgr.snapshot(sid)["generation"] == 0


def test_per_request_timeout_override(make_manager):
    mgr = make_manager(EngineCache(max_size=4), request_timeout_s=None,
                       step_retries=0, faults="step:1:hang:0.8")
    sid = mgr.create(dict(CUDA_SPEC, seed=59))["id"]
    with pytest.raises(DeadlineError):
        mgr.step(sid, 1, timeout_s=0.2)
    _drain(mgr)
    assert mgr.step(sid, 1)["generation"] == 1


def test_health_payload_after_a_trip(make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=1, retry_backoff_s=0.001,
                       faults="step:1-2:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=61))["id"]
    assert mgr.step(sid, 1)["generation"] == 1        # degraded, served
    h = mgr.health()
    assert h["ok"] and h["degraded_sessions"] == 1
    assert len(h["breaker"]["open"]) == 1 and h["breaker"]["trips"] == 1
    assert h["faults_injected"] == 2
    assert h["last_dispatch_ok_age_s"] is None        # no clean step yet
    assert mgr.stats()["failures"]["degraded_sessions"] == 1
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 61, 1))
