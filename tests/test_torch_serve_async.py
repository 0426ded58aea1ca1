"""The port's async ticketed stepping (``serve/ticket.py``) on the CPU:
the reference's ``tests/test_serve_async.py`` scenarios that need no
network front or server subprocess, against ``SessionManager(device=
"cpu")``.  Tickets carry the deadline/breaker/watchdog semantics of the
blocking verbs, the dispatch loop commits only completed chains, and
tickets of mixed depths share batched launches with boards equal to the
reference's ``serial_np`` oracle.  The counters of a mixed-depth burst are
the ones the reference's loop reaches for the same burst."""

import time

import numpy as np
import pytest

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.models.rules import LIFE
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.serve import (
    DeadlineError,
    EngineCache,
    EngineUnavailableError,
    SessionManager,
    TicketQueueFullError,
)

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
        thread = mgr.dispatcher and mgr.dispatcher._thread
        assert not (thread and thread.is_alive())


def _oracle(rows, cols, seed, steps, boundary="periodic", rule=LIFE):
    return evolve_np(init_tile_np(rows, cols, seed), steps, rule, boundary)


def _board(mgr, sid):
    return mgr.snapshot_array(sid)[0]


def _resolve(mgr, ticket, timeout_s=120):
    return mgr.ticket_result(ticket["ticket"], wait=True,
                             timeout_s=timeout_s)


# --------------------------------------------------------- basic tickets


def test_async_roundtrip_parity_and_result_shape(make_manager):
    mgr = make_manager(EngineCache(max_size=4))
    sid = mgr.create(dict(CUDA_SPEC, seed=51))["id"]
    t = mgr.step_async(sid, 3)
    assert t["status"] == "pending" and t["id"] == sid
    out = _resolve(mgr, t)
    assert out["status"] == "done"
    assert out["result"]["generation"] == 3
    assert out["result"]["steps"] == 3 and out["result"]["async"] is True
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 51, 3))
    assert mgr.ticket_result(t["ticket"])["result"] == out["result"]


def test_unknown_ticket_and_bad_steps(make_manager):
    mgr = make_manager(EngineCache(max_size=4))
    with pytest.raises(KeyError):
        mgr.ticket_result("t999")
    sid = mgr.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    with pytest.raises(ConfigError):
        mgr.step_async(sid, 0)
    with pytest.raises(KeyError):
        mgr.step_async("nope", 1)


def test_async_disabled_manager_rejects(make_manager):
    mgr = make_manager(EngineCache(max_size=4), async_enabled=False)
    sid = mgr.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    with pytest.raises(ConfigError):
        mgr.step_async(sid, 1)
    with pytest.raises(KeyError):
        mgr.ticket_result("t1")
    assert mgr.step(sid, 2)["generation"] == 2


def test_host_backend_tickets_resolve_in_order(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=20.0)
    sid = mgr.create({"rows": 32, "cols": 32, "backend": "serial",
                      "seed": 7})["id"]
    tickets = [mgr.step_async(sid, k) for k in (2, 3, 1)]
    gens = [_resolve(mgr, t)["result"]["generation"] for t in tickets]
    assert gens == [2, 5, 6]
    assert np.array_equal(_board(mgr, sid), _oracle(32, 32, 7, 6))


def test_cuda_tickets_of_one_session_resolve_in_order(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=20.0)
    sid = mgr.create(dict(CUDA_SPEC, seed=9))["id"]
    tickets = [mgr.step_async(sid, k) for k in (2, 3, 1, 4)]
    gens = [_resolve(mgr, t)["result"]["generation"] for t in tickets]
    assert gens == [2, 5, 6, 10]
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 9, 10))


# ------------------------------------------- heterogeneous-depth batching


def _enqueue_in_one_window(mgr, sids, depths):
    """Enqueue every ticket before the dispatch loop's first round: the
    loop takes its (re-entrant) condition before it reads the inbox, so
    holding it across the submits puts them all in one round."""
    with mgr.dispatcher._cv:
        return [mgr.step_async(s, d) for s, d in zip(sids, depths)]


@pytest.mark.parametrize("spec,rule", [
    (dict(CUDA_SPEC), "life"),
    (dict(rows=40, cols=64, rule="bosco"), "bosco"),                  # K3
    (dict(rows=40, cols=50, rule="bosco", comm_every=3), "bosco"),    # K2
    (dict(rows=96, cols=50, comm_every=3), "life"),           # padded seam
], ids=["k1", "k3", "k2", "k1-padded-seam"])
def test_mixed_depths_coalesce_with_oracle_parity(make_manager, spec, rule):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=20.0)
    depths = [1, 2, 5]
    sids = [mgr.create(dict(spec, seed=60 + i))["id"]
            for i in range(len(depths))]
    tickets = _enqueue_in_one_window(mgr, sids, depths)
    outs = [_resolve(mgr, t) for t in tickets]
    for i, (sid, d, out) in enumerate(zip(sids, depths, outs)):
        assert out["result"]["generation"] == d
        ref = _oracle(spec["rows"], spec["cols"], 60 + i, d,
                      rule=jax_rule_from_name(rule))
        assert np.array_equal(_board(mgr, sid), ref), (sid, d)
    assert max(o["result"]["max_batched"] for o in outs) == 3
    assert mgr.get(sids[0]).engine.batched_step_calls >= 1
    st = mgr.stats()["async"]
    assert st["tickets_completed"] == 3 and st["max_occupancy"] == 3
    assert st["board_rounds"] == 8 and st["unit_rounds"] == 5
    assert st["group_dispatches"] == 1


def test_unit_chain_needs_no_new_compiles(make_manager):
    mgr = make_manager(EngineCache(max_size=4))
    sid = mgr.create(dict(CUDA_SPEC, seed=71))["id"]
    engine = mgr.get(sid).engine
    before = engine.compile_count
    out = _resolve(mgr, mgr.step_async(sid, 5))
    assert out["result"]["generation"] == 5
    assert engine.compile_count == before
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 71, 5))


def test_pathological_depth_mix_one_sync_per_round(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=20.0)
    depths = [1, 16]
    sids = [mgr.create(dict(CUDA_SPEC, seed=80 + i))["id"]
            for i in range(len(depths))]
    tickets = _enqueue_in_one_window(mgr, sids, depths)
    outs = [_resolve(mgr, t) for t in tickets]
    for i, (sid, d, out) in enumerate(zip(sids, depths, outs)):
        assert out["result"]["generation"] == d
        assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 80 + i, d))
    assert outs[1]["result"]["max_batched"] == 2
    st = mgr.stats()["async"]
    assert st["group_dispatches"] == 1
    assert (st["unit_rounds"], st["board_rounds"]) == (16, 17)
    engine = mgr.get(sids[0]).engine
    # one batched step for the shared generation, 15 solo links after
    assert (engine.batched_step_calls, engine.step_calls) == (1, 15)


def test_resolved_ticket_ttl_retention(make_manager):
    mgr = make_manager(EngineCache(max_size=4), ticket_ttl_s=0.2)
    sid = mgr.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    t = mgr.step_async(sid, 1)
    assert _resolve(mgr, t)["status"] == "done"
    st = mgr.stats()["async"]
    assert st["ticket_ttl_s"] == 0.2 and st["tickets_retained"] >= 1
    time.sleep(0.3)
    assert mgr.stats()["async"]["tickets_retained"] == 0
    with pytest.raises(KeyError):
        mgr.ticket_result(t["ticket"])


def test_sync_and_async_interleave_consistently(make_manager):
    mgr = make_manager(EngineCache(max_size=4))
    sid = mgr.create(dict(CUDA_SPEC, seed=77))["id"]
    mgr.step(sid, 2)
    _resolve(mgr, mgr.step_async(sid, 3))
    mgr.step(sid, 1)
    assert mgr.snapshot(sid)["generation"] == 6
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 77, 6))


# ------------------------------------------------- tickets x fault paths


def test_queued_ticket_expires_before_dispatch(make_manager):
    mgr = make_manager(EngineCache(max_size=4), faults="step:1:delay:0.5")
    sid = mgr.create(dict(CUDA_SPEC, seed=81))["id"]
    engine = mgr.get(sid).engine
    with mgr.dispatcher._cv:            # both queued before the first round
        slow = mgr.step_async(sid, 1)
        doomed = mgr.step_async(sid, 1, timeout_s=0.1)
    assert _resolve(mgr, slow)["result"]["generation"] == 1
    with pytest.raises(DeadlineError, match="while queued"):
        mgr.ticket_result(doomed["ticket"], wait=True, timeout_s=30)
    assert engine.step_calls == 1
    assert mgr.dispatcher.tickets_expired == 1
    assert mgr.step(sid, 1)["generation"] == 2
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 81, 2))


def test_ticket_pending_while_breaker_opens_degrades_with_parity(
        make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=3,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=2, retry_backoff_s=0.001,
                       faults="step:1-5:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=91))["id"]
    out = _resolve(mgr, mgr.step_async(sid, 4))
    assert out["status"] == "done" and out["result"]["generation"] == 4
    s = mgr.get(sid)
    assert s.degraded and s.engine is None
    assert mgr.stats()["breaker"]["open"]
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 91, 4))


def test_ticket_unavailable_when_breaker_opens_without_degrade(
        make_manager):
    cache = EngineCache(max_size=4, breaker_threshold=2,
                        breaker_cooldown_s=60.0)
    mgr = make_manager(cache, step_retries=3, retry_backoff_s=0.001,
                       degrade=False, faults="step:*:raise")
    sid = mgr.create(dict(CUDA_SPEC, seed=95))["id"]
    t = mgr.step_async(sid, 1)
    with pytest.raises(EngineUnavailableError):
        mgr.ticket_result(t["ticket"], wait=True, timeout_s=30)
    assert mgr.get(sid).generation == 0


def test_group_chain_failure_falls_back_solo(make_manager):
    """A batched link that raises fails the whole chain: one engine
    failure, every ticket re-runs solo under its own deadline, and the
    boards are the oracle's."""
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=20.0,
                       retry_backoff_s=0.001, faults="batched:1:raise")
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in (11, 12)]
    tickets = _enqueue_in_one_window(mgr, sids, [2, 3])
    gens = [_resolve(mgr, t)["result"]["generation"] for t in tickets]
    assert gens == [2, 3]
    st = mgr.stats()["async"]
    assert st["batched_fallbacks"] == 1 and st["solo_tickets"] == 2
    assert mgr.engine_failures == 1
    for seed, sid, n in zip((11, 12), sids, (2, 3)):
        assert np.array_equal(_board(mgr, sid), _oracle(64, 64, seed, n))


def test_async_queue_bound_backpressure(make_manager):
    mgr = make_manager(EngineCache(max_size=4), async_queue_max=2)
    sid = mgr.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    with mgr.dispatcher._cv:            # nothing leaves the queue meanwhile
        mgr.step_async(sid, 1)
        mgr.step_async(sid, 1)
        with pytest.raises(TicketQueueFullError):
            mgr.step_async(sid, 1)


def test_shutdown_stops_the_loop_and_refuses_tickets(make_manager):
    mgr = make_manager(EngineCache(max_size=4))
    sid = mgr.create(dict(CUDA_SPEC, seed=3))["id"]
    _resolve(mgr, mgr.step_async(sid, 2))
    mgr.shutdown()
    assert not mgr.dispatcher._thread.is_alive()
    with pytest.raises(RuntimeError, match="stopped"):
        mgr.step_async(sid, 1)
    assert mgr.step(sid, 1)["generation"] == 3
