"""The port's serving session core (``mpi_tpu_torch.serve``) on the CPU:
the reference's ``tests/test_serve.py`` scenarios that need no network
front, run against the port's ``SessionManager(device="cpu")`` with
boards equal to the reference's ``serial_np`` oracle; the same scenarios
beside the reference's manager (``backend: "tpu"`` on a 1x1 JAX CPU mesh),
comparing ``describe()`` keys, cache stats, compile and batched-step
counts; the engine's window surfaces against numpy slicing; and eight
sessions sharing one engine stepped from eight threads.

Every manager is shut down by the ``make_manager`` fixture, so no
dispatch loop or watchdog worker outlives its test."""

import sys
import threading
import time

import numpy as np
import pytest
import torch

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.serve.cache import EngineCache as JaxEngineCache
from mpi_tpu.serve.session import SessionManager as JaxSessionManager
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch.backends import cuda as port
from mpi_tpu_torch.config import (
    SIGNATURE_FIELDS, ConfigError, GolConfig, plan_signature,
)
from mpi_tpu_torch.models.rules import BOSCO, LIFE
from mpi_tpu_torch.ops import bitlife
from mpi_tpu_torch.serve import EngineCache, SessionManager
from mpi_tpu_torch.serve.cache import signature_label

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
        assert mgr.dispatcher is None or mgr.dispatcher._thread is None \
            or not mgr.dispatcher._thread.is_alive()


def _oracle(rows, cols, seed, steps, boundary="periodic", rule="life"):
    return evolve_np(init_tile_np(rows, cols, seed), steps,
                     jax_rule_from_name(rule), boundary)


def _grid_of(snap):
    return np.array([[int(c) for c in row] for row in snap["grid"]],
                    dtype=np.uint8)


def _board(mgr, sid):
    return mgr.snapshot_array(sid)[0]


# ---------------------------------------------------------------- cache


def test_cache_hit_miss_counters():
    built = []
    cache = EngineCache(max_size=4)

    def factory(tag):
        def build():
            built.append(tag)
            return object()
        return build

    e1, hit1 = cache.get_or_build(("a",), factory("a"))
    e2, hit2 = cache.get_or_build(("a",), factory("a"))
    assert (hit1, hit2) == (False, True)
    assert e1 is e2 and built == ["a"]
    s = cache.stats()
    assert (s["hits"], s["misses"], s["evictions"], s["size"]) == (1, 1, 0, 1)


def test_cache_lru_eviction_and_bad_size():
    cache = EngineCache(max_size=2)
    cache.get_or_build(("a",), lambda: "A")
    cache.get_or_build(("b",), lambda: "B")
    cache.get_or_build(("a",), lambda: "A")      # touch a: b is now LRU
    cache.get_or_build(("c",), lambda: "C")      # evicts b
    assert ("a",) in cache and ("c",) in cache and ("b",) not in cache
    assert cache.stats()["evictions"] == 1
    _, hit = cache.get_or_build(("b",), lambda: "B")
    assert not hit and ("a",) not in cache
    with pytest.raises(ValueError):
        EngineCache(max_size=0)


def test_cache_batched_sub_cache():
    cache = EngineCache(max_size=2)
    s1, hit1 = cache.get_or_build_batched(("a",), 4, lambda: "A4")
    s2, hit2 = cache.get_or_build_batched(("a",), 4, lambda: "A4'")
    s3, hit3 = cache.get_or_build_batched(("a",), 2, lambda: "A2")
    assert (hit1, hit2, hit3) == (False, True, False)
    assert s1 is s2 and s1 == "A4" and s3 == "A2"
    b = cache.stats()["batched"]
    assert (b["hits"], b["misses"], b["size"], b["max_size"]) == (1, 2, 2, 8)
    for i in range(10):
        cache.get_or_build_batched(("churn", i), 1, lambda: i)
    b = cache.stats()["batched"]
    assert b["size"] <= b["max_size"] and b["evictions"] > 0


def test_plan_signature_is_the_references():
    from mpi_tpu.config import SIGNATURE_FIELDS as JAX_FIELDS
    from mpi_tpu.config import GolConfig as JaxConfig
    from mpi_tpu.config import plan_signature as jax_signature

    assert SIGNATURE_FIELDS == JAX_FIELDS
    a = GolConfig(rows=64, cols=64, steps=10, seed=0)
    b = GolConfig(rows=64, cols=64, steps=99, seed=7, snapshot_every=5)
    assert plan_signature(a, (1, 1)) == plan_signature(b, (1, 1))
    c = GolConfig(rows=64, cols=64, steps=10, boundary="dead")
    assert plan_signature(a, (1, 1)) != plan_signature(c, (1, 1))
    assert plan_signature(a, (1, 1), [1]) != plan_signature(a, (1, 1), [2])
    hash(plan_signature(a, (1, 1), [1, 2]))
    ref = jax_signature(JaxConfig(rows=64, cols=64, steps=3, comm_every=2,
                                  sparse_tile=0), (1, 1), [4, 1, 4])
    ours = plan_signature(GolConfig(rows=64, cols=64, steps=3, comm_every=2),
                          (1, 1), [4, 1, 4])
    assert len(ours) == len(ref) == len(SIGNATURE_FIELDS)
    # every field but the rule object and the backend's name is equal
    for name, x, y in zip(SIGNATURE_FIELDS, ours, ref):
        if name == "rule":
            assert str(x) == str(y)
        elif name != "backend":
            assert x == y, name
    assert signature_label(ours) == "64x64/cuda/periodic/mesh1x1/" + str(LIFE)


# -------------------------------------------------------------- sessions


def test_two_sessions_step_independently(make_manager):
    mgr = make_manager(EngineCache(max_size=4))
    a = mgr.create(dict(CUDA_SPEC, seed=3))
    b = mgr.create(dict(CUDA_SPEC, seed=11))
    mgr.step(a["id"], 3)
    mgr.step(b["id"], 5)
    mgr.step(a["id"], 2)
    snap_a, snap_b = mgr.snapshot(a["id"]), mgr.snapshot(b["id"])
    assert snap_a["generation"] == 5 and snap_b["generation"] == 5
    assert np.array_equal(_grid_of(snap_a), _oracle(64, 64, 3, 5))
    assert np.array_equal(_grid_of(snap_b), _oracle(64, 64, 11, 5))
    d = mgr.density(a["id"])
    assert d["population"] == int(_grid_of(snap_a).sum())
    assert d["density"] == pytest.approx(d["population"] / (64 * 64))


@pytest.mark.parametrize("spec,rule", [
    (dict(rows=48, cols=48, rule="highlife", boundary="dead"), "highlife"),
    (dict(rows=96, cols=50, comm_every=3), "life"),          # padded, seam
    (dict(rows=40, cols=64, rule="bosco", comm_every=1), "bosco"),   # K3
    (dict(rows=40, cols=48, rule="bosco", comm_every=3,
          boundary="dead"), "bosco"),                                # K2
    (dict(rows=32, cols=64, sparse_tile=32, segments=[1, 5]), "life"),
], ids=["k1-dead", "k1-padded-seam", "k3", "k2", "k1-sparse"])
def test_session_parity_on_every_engine(make_manager, spec, rule):
    mgr = make_manager()
    info = mgr.create(dict(spec, seed=2))
    for n in (1, 7, 5):
        mgr.step(info["id"], n)
    ref = _oracle(spec["rows"], spec["cols"], 2, 13,
                  boundary=spec.get("boundary", "periodic"), rule=rule)
    assert np.array_equal(_board(mgr, info["id"]), ref)
    assert mgr.density(info["id"])["population"] == int(ref.sum())


def test_serial_backend_session_parity(make_manager):
    mgr = make_manager()
    info = mgr.create({"rows": 48, "cols": 48, "backend": "serial",
                       "seed": 2, "rule": "highlife", "boundary": "dead"})
    mgr.step(info["id"], 7)
    ref = _oracle(48, 48, 2, 7, boundary="dead", rule="highlife")
    assert np.array_equal(_grid_of(mgr.snapshot(info["id"])), ref)


def test_second_session_zero_compiles(make_manager):
    """An identical plan signature costs zero new compiles on the second
    create, and stepping at a warmed depth adds none."""
    mgr = make_manager(EngineCache(max_size=4))
    spec = dict(CUDA_SPEC, segments=[1, 4])
    first = mgr.create(dict(spec))
    compiles = first["engine_compiles"]
    assert compiles == 2                        # depths 1 and 4 warmed
    second = mgr.create(dict(spec, seed=5))     # seed is not in the key
    assert second["cache_hit"] and not first["cache_hit"]
    assert second["engine_compiles"] == compiles
    s = mgr.cache.stats()
    assert (s["hits"], s["misses"]) == (1, 1)
    mgr.step(first["id"], 4)
    mgr.step(second["id"], 4)
    assert mgr.stats()["sessions"][0]["engine_compiles"] == compiles
    # a new depth is warmed once and charged to setup, not to stepping
    engine = mgr.get(first["id"]).engine
    wall = engine.compile_wall_s
    mgr.step(first["id"], 3)
    mgr.step(second["id"], 3)
    assert engine.compile_count == compiles + 1
    assert engine.compile_wall_s >= wall


def test_session_errors(make_manager):
    mgr = make_manager()
    with pytest.raises(ConfigError):
        mgr.create({"rows": 32})                # missing cols
    with pytest.raises(ConfigError):
        mgr.create({"rows": 32, "cols": 32, "bogus": 1})
    with pytest.raises(KeyError):
        mgr.step("nope", 1)
    info = mgr.create({"rows": 32, "cols": 32, "backend": "serial"})
    with pytest.raises(ConfigError):
        mgr.step(info["id"], 0)
    mgr.close(info["id"])
    with pytest.raises(KeyError):
        mgr.snapshot(info["id"])


@pytest.mark.parametrize("backend", ["cpp", "cpp-par"])
def test_native_backends_name_their_roadmap_item(make_manager, backend):
    """ROADMAP queue 1 item 16 is done: the native backends serve, on the
    host, bit for bit with the oracle, and hold no engine."""
    mgr = make_manager()
    sid = mgr.create({"rows": 32, "cols": 32, "backend": backend,
                      "seed": 4})["id"]
    assert mgr.step(sid, 5)["generation"] == 5
    assert mgr.get(sid).engine is None and mgr.get(sid).plan_sig is None
    assert np.array_equal(_board(mgr, sid), _oracle(32, 32, 4, 5))


@pytest.mark.parametrize("kw,item", [(dict(tune_cache="x"), "item 12")])
def test_obs_and_tune_cache_name_their_roadmap_item(kw, item, tmp_path):
    """ROADMAP queue 1 item 12 is done: a ``tune_cache`` path opens a
    ``TuneCache`` (a missing file is an empty cache), and every cuda
    create builds through it."""
    from mpi_tpu_torch.tune import TuneCache

    path = str(tmp_path / kw["tune_cache"])
    mgr = SessionManager(device="cpu", tune_cache=path)
    try:
        assert isinstance(mgr.tune_cache, TuneCache)
        assert mgr.tune_cache.path == path and len(mgr.tune_cache) == 0
        assert mgr.tune_cache.load_error is None
        s = mgr.create({"rows": 32, "cols": 32, "seed": 4})
        assert mgr.get(s["id"]).engine.tuned_plan is None
        assert "tuned_plan" not in s
    finally:
        mgr.shutdown()


def test_default_backend_is_cuda_on_the_card():
    """Without ``device`` the manager builds on the GPU: with no card, a
    cuda create raises rather than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    mgr = SessionManager(async_enabled=False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mgr.create({"rows": 32, "cols": 32})
    assert len(mgr) == 0


# --------------------------------------------------- side by side with JAX


def _jax_manager(**kw):
    return JaxSessionManager(JaxEngineCache(max_size=4), async_enabled=False,
                             **kw)


def _counts(mgr, sid):
    d = mgr.describe(mgr.get(sid))
    return (d["engine_compiles"], d["engine_batched_compiles"],
            d["batched_steps"], d["cache_hit"], d["generation"])


def test_create_and_cache_side_by_side(make_manager):
    ours = make_manager(EngineCache(max_size=4), async_enabled=False)
    ref = _jax_manager()
    spec = {"rows": 64, "cols": 64, "segments": [1, 4], "mesh": "1x1"}
    for seed in (1, 2):
        a = ours.create(dict(spec, seed=seed))
        b = ref.create(dict(spec, seed=seed, backend="tpu"))
        assert set(a) == set(b)
        assert a["cache"] == b["cache"]
        ours.step(a["id"], 4)
        ref.step(b["id"], 4)
        assert _counts(ours, a["id"]) == _counts(ref, b["id"])
        assert np.array_equal(_board(ours, a["id"]), _board(ref, b["id"]))
    s_ours, s_ref = ours.stats(), ref.stats()
    assert set(s_ours) == set(s_ref)
    assert s_ours["cache"] == s_ref["cache"]
    assert s_ours["breaker"] == s_ref["breaker"]
    assert s_ours["failures"] == s_ref["failures"]


def test_coalesced_batch_side_by_side(make_manager):
    """Four sessions stepped at once coalesce into one batched step in
    both managers, with equal batch stats, counts and boards."""
    ours = make_manager(EngineCache(max_size=4), async_enabled=False,
                        batch_window_ms=1000.0)
    ref = _jax_manager(batch_window_ms=1000.0)
    out = {}
    for mgr, backend in ((ours, "cuda"), (ref, "tpu")):
        sids = [mgr.create({"rows": 64, "cols": 64, "backend": backend,
                            "mesh": "1x1", "seed": s})["id"]
                for s in (1, 2, 3, 4)]
        for _ in range(2):
            _step_all_concurrently(mgr, sids)
        engine = mgr.get(sids[0]).engine
        stats = mgr.stats()["batch"]
        for k in ("window_ms", "batched_step_s", "solo_step_s",
                  "amortized_board_step_s"):
            stats.pop(k)
        out[backend] = (stats, mgr.cache.stats(), engine.batched_step_calls,
                        engine.step_calls, engine.compile_count,
                        engine.batched_compile_count,
                        [_counts(mgr, s) for s in sids],
                        [_board(mgr, s) for s in sids])
    assert out["cuda"][:7] == out["tpu"][:7]
    assert out["cuda"][2] == 2 and out["cuda"][3] == 0
    for a, b in zip(out["cuda"][7], out["tpu"][7]):
        assert np.array_equal(a, b)


# -------------------------------------------------------- microbatching


def _step_all_concurrently(mgr, sids, steps=1):
    results, errors = {}, []

    def go(sid, n):
        try:
            results.setdefault(sid, []).append(mgr.step(sid, n))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(s, steps)) for s in sids]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]
    return results


def test_scheduler_coalesces_same_signature(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=1000.0,
                       batch_max=8)
    seeds = [1, 2, 3, 4]
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in seeds]
    engine = mgr.get(sids[0]).engine
    results = _step_all_concurrently(mgr, sids)
    assert engine.batched_step_calls == 1 and engine.step_calls == 0
    assert all(r[0]["generation"] == 1 and r[0]["batched"] == 4
               for r in results.values())
    st = mgr.stats()["batch"]
    assert (st["coalesced_calls"], st["batched_boards"],
            st["max_occupancy"]) == (1, 4, 4)
    for seed, sid in zip(seeds, sids):
        assert np.array_equal(_board(mgr, sid), _oracle(64, 64, seed, 1))
    compiles = engine.compile_count
    _step_all_concurrently(mgr, sids)
    assert engine.batched_step_calls == 2
    assert engine.compile_count == compiles
    b = mgr.cache.stats()["batched"]
    assert b["hits"] >= 1 and b["misses"] == 1
    desc = mgr.describe(mgr.get(sids[0]))
    assert desc["batched_steps"] == 2 and desc["engine_batched_compiles"] == 1


def test_scheduler_mixed_depths_do_not_coalesce(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=200.0)
    a = mgr.create(dict(CUDA_SPEC, seed=5))["id"]
    b = mgr.create(dict(CUDA_SPEC, seed=6))["id"]
    engine = mgr.get(a).engine
    threads = [threading.Thread(target=mgr.step, args=(a, 1)),
               threading.Thread(target=mgr.step, args=(b, 2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert engine.batched_step_calls == 0
    assert np.array_equal(_board(mgr, a), _oracle(64, 64, 5, 1))
    assert np.array_equal(_board(mgr, b), _oracle(64, 64, 6, 2))


def test_scheduler_duplicate_session_steps_twice(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=300.0)
    sid = mgr.create(dict(CUDA_SPEC, seed=17))["id"]
    _step_all_concurrently(mgr, [sid, sid])
    session = mgr.get(sid)
    assert session.generation == 2
    assert session.engine.batched_step_calls == 0
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 17, 2))


def test_scheduler_disabled_steps_solo(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batching=False)
    sid = mgr.create(dict(CUDA_SPEC, seed=21))["id"]
    r = mgr.step(sid, 2)
    assert r["generation"] == 2 and "batched" not in r
    assert "batch" not in mgr.stats()
    assert np.array_equal(_board(mgr, sid), _oracle(64, 64, 21, 2))


def test_batched_failure_falls_back_solo_with_parity(make_manager):
    """A batched step that raises leaves every board untouched and steps
    each solo: counted as a fallback, results unchanged."""
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=1000.0,
                       faults="batched:1:raise")
    sids = [mgr.create(dict(CUDA_SPEC, seed=s))["id"] for s in (7, 8)]
    _step_all_concurrently(mgr, sids, steps=3)
    assert mgr.stats()["batch"]["batched_fallbacks"] == 1
    for seed, sid in zip((7, 8), sids):
        assert np.array_equal(_board(mgr, sid), _oracle(64, 64, seed, 3))


@pytest.mark.parametrize("batching", [False, True], ids=["solo", "batched"])
def test_eight_threads_share_one_engine(make_manager, batching):
    """Eight sessions on one engine, each stepped from its own thread at
    mixed depths: no two share a buffer, so every board equals the
    oracle at its generation."""
    mgr = make_manager(EngineCache(max_size=4), batching=batching,
                       batch_window_ms=5.0, batch_max=8, async_enabled=False)
    seeds = list(range(30, 38))
    sids = [mgr.create(dict(CUDA_SPEC, seed=s, segments=[1, 2, 3]))["id"]
            for s in seeds]
    engine = mgr.get(sids[0]).engine
    assert all(mgr.get(s).engine is engine for s in sids)
    depths = [1, 2, 3, 1, 2]
    errors = []

    def run(sid):
        try:
            for n in depths:
                mgr.step(sid, n)
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(s,)) for s in sids]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    for seed, sid in zip(seeds, sids):
        assert mgr.get(sid).generation == sum(depths)
        assert np.array_equal(_board(mgr, sid),
                              _oracle(64, 64, seed, sum(depths)))


# ------------------------------------------------------------- races


def test_snapshot_density_generation_not_torn(make_manager):
    rows = cols = 32
    total = 40
    oracle = [init_tile_np(rows, cols, 4)]
    for _ in range(total):
        oracle.append(evolve_np(oracle[-1], 1, jax_rule_from_name("life"),
                                "periodic"))
    mgr = make_manager(batching=False)
    sid = mgr.create({"rows": rows, "cols": cols, "seed": 4})["id"]
    done = threading.Event()

    def stepper():
        for _ in range(total):
            mgr.step(sid, 1)
        done.set()

    t = threading.Thread(target=stepper)
    t.start()
    try:
        while not done.is_set():
            snap = mgr.snapshot(sid)
            assert np.array_equal(_grid_of(snap), oracle[snap["generation"]])
            d = mgr.density(sid)
            assert d["population"] == int(oracle[d["generation"]].sum())
    finally:
        t.join(timeout=120)
    assert mgr.get(sid).generation == total


def test_stats_describe_close_race(make_manager):
    mgr = make_manager()
    stop = threading.Event()
    errors = []

    def churn():
        try:
            for _ in range(30):
                info = mgr.create({"rows": 32, "cols": 32})
                mgr.close(info["id"])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
        finally:
            stop.set()

    t = threading.Thread(target=churn)
    t.start()
    try:
        while not stop.is_set():
            for s in mgr.stats()["sessions"]:
                assert "id" in s
    finally:
        t.join(timeout=120)
    assert not errors


def test_close_racing_batched_step(make_manager):
    mgr = make_manager(EngineCache(max_size=4), batch_window_ms=2000.0)
    a = mgr.create(dict(CUDA_SPEC, seed=71))["id"]
    b = mgr.create(dict(CUDA_SPEC, seed=72))["id"]
    results, errors = {}, {}

    def go(sid):
        try:
            results[sid] = mgr.step(sid, 1)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors[sid] = e

    ta = threading.Thread(target=go, args=(a,))
    tb = threading.Thread(target=go, args=(b,))
    ta.start()
    tb.start()
    # close b once both requests wait in the coalescing queue
    t_end = time.monotonic() + 60
    while mgr.batcher.queue_depth() < 2 and time.monotonic() < t_end:
        time.sleep(0.001)
    assert mgr.batcher.queue_depth() == 2
    mgr.close(b)
    ta.join(timeout=120)
    tb.join(timeout=120)
    assert isinstance(errors.get(b), KeyError)
    assert results[a]["generation"] == 1
    assert np.array_equal(_board(mgr, a), _oracle(64, 64, 71, 1))
    with pytest.raises(KeyError):
        mgr.snapshot(b)


# ----------------------------------------------------------- windows


WINDOW_ENGINES = [
    (dict(cols=64), "bit", 0),
    (dict(cols=100, comm_every=3), "bit", 28),                # padded, seam
    (dict(cols=50, rule=BOSCO, boundary="dead"), "ltl", 14),  # padded
    (dict(cols=70, rule=BOSCO, comm_every=3), "dense", 0),
]
WINDOWS = [(0, 0, 1, 1), (3, 5, 7, 40), (0, 31, 24, 2), (10, 33, 5, 1),
           (23, 0, 1, 50)]


@pytest.mark.parametrize("kw,kind,pad", WINDOW_ENGINES,
                         ids=[f"{k}-pad{p}" for _, k, p in WINDOW_ENGINES])
def test_fetch_and_write_window_match_numpy(kw, kind, pad):
    eng = port.build_engine(GolConfig(rows=24, steps=0, seed=3, **kw),
                            device="cpu")
    assert (eng.kind, eng.pad_bits) == (kind, pad)
    grid = eng.step(eng.init_grid(), 5)
    full = eng.fetch(grid)
    rng = np.random.default_rng(0)
    timed = []
    for r0, c0, h, w in WINDOWS + [(2, kw["cols"] - 9, 6, 9)]:
        win = eng.fetch_window(grid, r0, c0, h, w, shard_timer=timed.append)
        assert win.dtype == np.uint8
        assert np.array_equal(win, full[r0:r0 + h, c0:c0 + w])
        patch = rng.integers(0, 2, (h, w), dtype=np.uint8)
        out = eng.write_window(grid, r0, c0, patch)
        assert out is grid                      # edited in place
        full[r0:r0 + h, c0:c0 + w] = patch
        assert np.array_equal(eng.fetch(grid), full)
        if eng.bitpacked:                       # the pad stays dead
            assert not bitlife.unpack(grid)[:, kw["cols"]:].any()
    assert len(timed) == len(WINDOWS) + 1       # one transfer a window
    assert eng.shard_snapshots(grid)[0][:2] == (0, 0)
    assert np.array_equal(eng.shard_snapshots(grid)[0][2], full)
    with pytest.raises(ValueError):
        eng.fetch_window(grid, 20, 0, 5, 1)     # leaves the board


def test_write_window_is_none_on_a_sparse_engine():
    eng = port.build_engine(GolConfig(rows=32, cols=64, steps=0,
                                      sparse_tile=32), device="cpu")
    state = eng.init_grid()
    assert eng.write_window(state, 0, 0, np.ones((2, 2), np.uint8)) is None
    assert np.array_equal(eng.fetch_window(state, 1, 2, 3, 40),
                          eng.fetch(state)[1:4, 2:42])


@pytest.mark.parametrize("spec", [
    dict(rows=64, cols=96), dict(rows=40, cols=50),
    dict(rows=32, cols=64, sparse_tile=32), dict(rows=32, cols=40,
                                                 backend="serial")],
    ids=["k1", "k1-padded", "k1-sparse", "serial"])
def test_session_windows_wrap_and_write(make_manager, spec):
    mgr = make_manager()
    sid = mgr.create(dict(spec, seed=5))["id"]
    mgr.step(sid, 3)
    R, C = spec["rows"], spec["cols"]
    full = _board(mgr, sid)
    win, gen, _ = mgr.snapshot_window(sid, 10, 20, 8, 16)
    assert gen == 3 and np.array_equal(win, full[10:18, 20:36])
    wrapped, _, _ = mgr.snapshot_window(sid, R - 4, C - 5, 8, 12)
    rows = [(R - 4 + i) % R for i in range(8)]
    cols = [(C - 5 + j) % C for j in range(12)]
    assert np.array_equal(wrapped, full[np.ix_(rows, cols)])
    patch = (np.arange(5 * 9).reshape(5, 9) % 2).astype(np.uint8)
    out = mgr.write_window(sid, R - 2, C - 4, patch)
    assert out["written"] and out["generation"] == 3
    full[np.ix_([(R - 2 + i) % R for i in range(5)],
                [(C - 4 + j) % C for j in range(9)])] = patch
    assert np.array_equal(_board(mgr, sid), full)
    mgr.step(sid, 2)
    ref = evolve_np(full, 2, jax_rule_from_name("life"), "periodic")
    assert np.array_equal(_board(mgr, sid), ref)
    board = np.zeros((R, C), np.uint8)
    assert mgr.write_board(sid, board, generation=7)["generation"] == 7
    assert not _board(mgr, sid).any()


def test_engine_surfaces_of_the_reference():
    eng = port.build_engine(GolConfig(rows=24, cols=64, steps=0), "cpu")
    assert (eng.mi, eng.mj, eng.obs, eng.tuned_plan) == (1, 1, None, None)
    assert eng.cost_card(1) is None and eng.cost_cards() == []
    grid = eng.init_grid(initial=lambda r0, r1, c0, c1:
                         init_tile_np(24, 64, 9)[r0:r1, c0:c1])
    assert np.array_equal(eng.fetch(grid), init_tile_np(24, 64, 9))
    assert eng.block_until_ready(grid) is grid
    eng.compile_segments(grid, [1, 4, 4])
    assert eng.compile_count == 2 and eng.batched_compile_count == 0
    eng.ensure_compiled(grid, 4)
    eng.ensure_compiled_batched(torch.stack([grid, grid]), 4)
    eng.ensure_compiled_batched(torch.stack([grid, grid]), 4)
    assert (eng.compile_count, eng.batched_compile_count) == (3, 1)
    calls = []
    eng.fault_hook = calls.append
    grid = eng.step(grid, 2)
    eng.step_batched(torch.stack([grid, grid]), 1)
    assert calls == ["step", "batched"]
