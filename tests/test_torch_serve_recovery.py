"""The port's checkpoint/restore (``serve/recovery.py``, the reference's
copy, and the ``SessionManager`` state-dir wiring) on the CPU: the
reference's ``tests/test_serve_recovery.py`` scenarios that need no
server subprocess, and the store-level durability scenarios of
``tests/test_serve_durability.py``, against ``SessionManager(device=
"cpu")``.  A session that lives through a restart (a fresh manager over
the same state dir) equals the same session stepped without one, on
every kernel's engine.  The reference's ``StateStore`` and the port's
write the same bytes for the same operations and read each other's
records, and a session written by either manager restores in the other."""

import json
import os
import shutil

import numpy as np
import pytest

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.models.rules import LIFE
from mpi_tpu.models.rules import rule_from_name as jax_rule_from_name
from mpi_tpu.serve import recovery as jax_recovery
from mpi_tpu.serve.cache import EngineCache as JaxEngineCache
from mpi_tpu.serve.session import SessionManager as JaxSessionManager
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch.serve import EngineCache, SessionManager, recovery
from mpi_tpu_torch.serve.faults import FaultInjector
from mpi_tpu_torch.serve.recovery import (
    RecordCorrupt, StateStore, StorageDegradedError,
)


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


def _oracle(rows, cols, seed, steps, boundary="periodic", rule=LIFE):
    return evolve_np(init_tile_np(rows, cols, seed), steps, rule, boundary)


def _board(mgr, sid):
    return mgr.snapshot_array(sid)[0]


# ------------------------------------------------------------- store


def test_grid_codec_roundtrip():
    g = init_tile_np(13, 37, 5)                 # odd shape: packbits pads
    assert np.array_equal(recovery.decode_grid(recovery.encode_grid(g)), g)
    assert recovery.encode_grid(g) == jax_recovery.encode_grid(g)


def test_statestore_save_load_delete(tmp_path):
    store = StateStore(str(tmp_path), checkpoint_every=8)
    spec = {"rows": 16, "cols": 16, "backend": "serial", "seed": 3}
    snap = recovery.encode_grid(init_tile_np(16, 16, 3))
    snap["generation"] = 4
    store.save("s2", spec, 7, snap)
    store.save("s1", spec, 1, None)
    recs = store.load_records()
    assert [r["id"] for r in recs] == ["s1", "s2"]
    assert recs[1]["generation"] == 7
    assert recs[1]["snapshot"]["generation"] == 4
    assert np.array_equal(recovery.decode_grid(recs[1]["snapshot"]),
                          init_tile_np(16, 16, 3))
    store.delete("s1")
    assert [r["id"] for r in store.load_records()] == ["s2"]
    st = store.stats()
    assert st["writes"] == 2 and st["snapshot_writes"] == 1
    assert st["deletes"] == 1 and st["load_errors"] == 0


def test_statestore_skips_corrupt_and_alien_files(tmp_path):
    store = StateStore(str(tmp_path))
    store.save("s1", {"rows": 16, "cols": 16, "backend": "serial"}, 2, None)
    (tmp_path / "s9.json").write_text("{torn json")
    (tmp_path / "s8.json").write_text('{"v": 99, "id": "s8"}')
    (tmp_path / "notes.txt").write_text("not a record")
    assert [r["id"] for r in store.load_records()] == ["s1"]
    assert store.stats()["load_errors"] == 2


def test_v2_envelope_magic_and_crc(tmp_path):
    store = StateStore(str(tmp_path))
    store.save("s1", {"rows": 16, "cols": 16, "backend": "serial"}, 5, None)
    raw = (tmp_path / "s1.json").read_bytes()
    assert raw[:4] == b"GOLS" and raw[4] == recovery.RECORD_VERSION
    assert recovery._rec_decode(raw)["generation"] == 5
    bad = bytearray(raw)
    bad[len(raw) // 2] ^= 0x40
    with pytest.raises(RecordCorrupt):
        recovery._rec_decode(bytes(bad))


def _seeded_chain(path):
    store = StateStore(str(path), journal=False, keep=2)
    spec = {"rows": 16, "cols": 16, "backend": "serial", "seed": 7}
    for gen in (3, 6):
        snap = recovery.encode_grid(_oracle(16, 16, 7, gen))
        snap["generation"] = gen
        store.save("s1", spec, gen, snap)


def test_torn_or_rotted_head_falls_back_to_the_ancestor(tmp_path):
    _seeded_chain(tmp_path / "seed")
    head = (tmp_path / "seed" / "s1.json").read_bytes()
    cases = [head[:off] for off in range(0, len(head), 5)]
    for pos in range(0, len(head), 11):
        bad = bytearray(head)
        bad[pos] ^= 1 << (pos % 8)
        cases.append(bytes(bad))
    for i, raw in enumerate(cases):
        d = tmp_path / f"c{i}"
        shutil.copytree(tmp_path / "seed", d)
        (d / "s1.json").write_bytes(raw)
        store = StateStore(str(d), journal=False)
        rec = store.load_record("s1")
        assert rec is not None and rec["generation"] == 3, i
        assert np.array_equal(recovery.decode_grid(rec["snapshot"]),
                              _oracle(16, 16, 7, 3))
        assert store.corrupt_records == 1
        shutil.rmtree(d)


# ------------------------------------------------ the reference's store


def _store_ops(store_cls, path):
    """One sequence of store operations: full records, journal content
    and delta entries, bare marks, a compaction, a second session and a
    delete."""
    store = store_cls(str(path), checkpoint_every=2, journal_max_bytes=150)
    spec = {"rows": 24, "cols": 40, "backend": "serial", "seed": 9}
    g = init_tile_np(24, 40, 9)
    store.save("s1", spec, 0, None)
    for gen in range(1, 9):
        g = evolve_np(g, 1, LIFE, "periodic")
        snap = None
        if gen % 2 == 0:
            snap = recovery.encode_grid(g)
            snap["generation"] = gen
        store.commit_step("s1", spec, gen, snap,
                          grid=g if snap is not None else None)
    store.save("s2", dict(spec, seed=3), 4, None)
    store.save("s3", spec, 1, None)
    store.delete("s3")
    return store


@pytest.mark.parametrize("writer,reader", [
    (jax_recovery.StateStore, StateStore),
    (StateStore, jax_recovery.StateStore)], ids=["reference-to-port",
                                                 "port-to-reference"])
def test_checkpoints_cross_between_the_stores(tmp_path, writer, reader):
    """The same operations leave the same bytes in both stores' dirs,
    and a record written by one store loads in the other as it loads in
    its writer."""
    w = _store_ops(writer, tmp_path / "w")
    _store_ops(reader, tmp_path / "r")
    names = sorted(os.listdir(tmp_path / "w"))
    assert names == sorted(os.listdir(tmp_path / "r"))
    assert any(n.endswith(".journal") for n in names)
    assert w.stats()["compactions"] > 0
    for name in names:
        assert ((tmp_path / "w" / name).read_bytes()
                == (tmp_path / "r" / name).read_bytes()), name
    got = reader(str(tmp_path / "w")).load_records()
    want = writer(str(tmp_path / "w")).load_records()
    assert [r["id"] for r in got] == ["s1", "s2"]
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got[0]["generation"] == 8
    assert np.array_equal(recovery.decode_grid(got[0]["snapshot"]),
                          _oracle(24, 40, 9, 8))


@pytest.mark.parametrize("first", ["port", "reference"])
def test_a_session_restores_across_the_managers(make_manager, tmp_path,
                                                first):
    """A serial session written by one manager restores in the other and
    steps on, equal to the oracle."""
    def port():
        return make_manager(EngineCache(max_size=2), state_dir=str(tmp_path),
                            checkpoint_every=3)

    def reference():
        return JaxSessionManager(JaxEngineCache(max_size=2),
                                 state_dir=str(tmp_path), checkpoint_every=3,
                                 async_enabled=False)

    make = {"port": port, "reference": reference}
    m1 = make[first]()
    sid = m1.create({"rows": 32, "cols": 40, "backend": "serial",
                     "seed": 12, "rule": "highlife"})["id"]
    for n in (1, 3, 1, 2):
        m1.step(sid, n)
    m2 = make["reference" if first == "port" else "port"]()
    assert m2.restored_sessions == 1 and m2.get(sid).generation == 7
    m2.step(sid, 2)
    assert np.array_equal(_board(m2, sid),
                          _oracle(32, 40, 12, 9,
                                  rule=jax_rule_from_name("highlife")))


# ------------------------------------------------------------- restore


def test_host_restore_parity(make_manager, tmp_path):
    k, m = 7, 5
    m1 = make_manager(state_dir=str(tmp_path), checkpoint_every=4)
    sid = m1.create({"rows": 48, "cols": 48, "backend": "serial",
                     "seed": 9})["id"]
    for _ in range(k):
        m1.step(sid, 1)
    before = _board(m1, sid)
    m2 = make_manager(state_dir=str(tmp_path))
    assert m2.restored_sessions == 1
    s = m2.get(sid)
    assert s.restored and s.generation == k
    assert np.array_equal(_board(m2, sid), before)
    for _ in range(m):
        m2.step(sid, 1)
    assert np.array_equal(_board(m2, sid), _oracle(48, 48, 9, k + m))
    assert m2.describe(s)["restored"] is True
    assert m2.stats()["recovery"]["restored_sessions"] == 1
    assert m2.health()["restored_sessions"] == 1


@pytest.mark.parametrize("spec,rule", [
    (dict(rows=64, cols=64), "life"),
    (dict(rows=96, cols=50, comm_every=3), "life"),           # padded seam
    (dict(rows=40, cols=64, rule="bosco"), "bosco"),                  # K3
    (dict(rows=40, cols=50, rule="bosco", comm_every=3), "bosco"),    # K2
    (dict(rows=32, cols=64, sparse_tile=32), "life"),         # sparse K1
], ids=["k1", "k1-padded-seam", "k3", "k2", "k1-sparse"])
def test_cuda_restore_parity(make_manager, tmp_path, spec, rule):
    """After a shutdown, a new manager over the same state dir rebuilds
    the board (the last snapshot, then depth-1 replay) bit-identically,
    and both the restored and the uninterrupted session step on
    equal."""
    k, m = 5, 3
    m1 = make_manager(state_dir=str(tmp_path), checkpoint_every=3)
    sid = m1.create(dict(spec, seed=13))["id"]
    for n in (2, 1, 2):
        m1.step(sid, n)
    before = _board(m1, sid)
    m1.shutdown()
    m2 = make_manager(state_dir=str(tmp_path))
    s = m2.get(sid)
    assert s.restored and s.engine is not None and s.generation == k
    assert np.array_equal(_board(m2, sid), before)
    for _ in range(m):
        m1.step(sid, 1)
        m2.step(sid, 1)
    ref = _oracle(spec["rows"], spec["cols"], 13, k + m,
                  rule=jax_rule_from_name(rule))
    assert np.array_equal(_board(m2, sid), ref)
    assert np.array_equal(_board(m1, sid), ref)


def test_restore_without_snapshot_replays_from_seed(make_manager, tmp_path):
    m1 = make_manager(state_dir=str(tmp_path), checkpoint_every=1000)
    sid = m1.create({"rows": 32, "cols": 32, "seed": 4})["id"]
    m1.step(sid, 6)
    m2 = make_manager(state_dir=str(tmp_path))
    assert np.array_equal(_board(m2, sid), _oracle(32, 32, 4, 6))


def test_close_deletes_record_and_new_ids_advance(make_manager, tmp_path):
    m1 = make_manager(state_dir=str(tmp_path))
    a = m1.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    b = m1.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    m1.close(a)
    m2 = make_manager(state_dir=str(tmp_path))
    with pytest.raises(KeyError):
        m2.get(a)
    assert m2.get(b) is not None
    c = m2.create({"rows": 16, "cols": 16, "backend": "serial"})["id"]
    assert c not in (a, b)


@pytest.mark.parametrize("backend", ["nope", "cpp"])
def test_restore_salvages_around_bad_record(make_manager, tmp_path, backend):
    m1 = make_manager(state_dir=str(tmp_path))
    sid = m1.create({"rows": 16, "cols": 16, "backend": "serial",
                     "seed": 2})["id"]
    m1.step(sid, 3)
    # "nope" is no backend; cpp is one, but takes no comm_every
    bad = {"comm_every": 2} if backend == "cpp" else {}
    (tmp_path / "s7.json").write_text(json.dumps({
        "v": 1, "id": "s7", "generation": 1,
        "spec": {"rows": 16, "cols": 16, "backend": backend, **bad},
    }))
    m2 = make_manager(state_dir=str(tmp_path))
    assert m2.restored_sessions == 1 and m2.restore_errors == 1
    assert np.array_equal(_board(m2, sid), _oracle(16, 16, 2, 3))


def test_journal_replays_and_compacts(make_manager, tmp_path):
    k = 9
    m1 = make_manager(state_dir=str(tmp_path), checkpoint_every=1,
                      journal_max_bytes=300)
    sid = m1.create({"rows": 24, "cols": 64, "seed": 11})["id"]
    for _ in range(k):
        m1.step(sid, 1)
    st = m1.store.stats()
    assert st["journal_appends"] > 0 and st["compactions"] > 0
    m2 = make_manager(state_dir=str(tmp_path))
    assert m2.get(sid).generation == k
    assert np.array_equal(_board(m2, sid), _oracle(24, 64, 11, k))


def test_written_board_anchors_the_restore(make_manager, tmp_path):
    """A write replaces replay-from-seed: the record carries the written
    board, and the restore steps on from it."""
    m1 = make_manager(state_dir=str(tmp_path), checkpoint_every=100)
    sid = m1.create({"rows": 32, "cols": 64, "seed": 1})["id"]
    m1.step(sid, 2)
    patch = np.ones((3, 5), np.uint8)
    m1.write_window(sid, 30, 62, patch)         # wraps both axes
    board = _board(m1, sid)
    m1.step(sid, 4)
    m2 = make_manager(state_dir=str(tmp_path))
    assert m2.get(sid).generation == 6
    assert np.array_equal(_board(m2, sid),
                          evolve_np(board, 4, LIFE, "periodic"))


# -------------------------------------------------- io faults, degraded


def test_io_torn_write_degrades_then_recovers(tmp_path):
    store = StateStore(str(tmp_path))
    store.fault_hook = FaultInjector.from_spec("io-write:1:torn:0.25").io_hook
    spec = {"rows": 16, "cols": 16, "backend": "serial", "seed": 1}
    with pytest.raises(OSError):
        store.save("s1", spec, 1, None)
    assert store.persistence_state()["state"] == "degraded"
    assert not list(tmp_path.glob("*.tmp*"))
    with pytest.raises(StorageDegradedError) as ei:
        store.save("s1", spec, 2, None)
    assert ei.value.retry_after_s > 0 and store.take_pending() == ["s1"]
    store._retry_at = 0.0
    store.save("s1", spec, 3, None)
    assert store.persistence_state()["state"] == "closed"
    assert store.load_record("s1")["generation"] == 3


def test_enospc_degraded_recovery_loses_no_generation(make_manager,
                                                      tmp_path):
    mgr = make_manager(state_dir=str(tmp_path), checkpoint_every=1,
                       faults="io-write:2:enospc")
    sid = mgr.create({"rows": 16, "cols": 32, "seed": 6})["id"]
    mgr.step(sid, 1)                    # commit write #2 hits ENOSPC
    h = mgr.health()
    assert h["ok"] is True and h["persistence"]["state"] == "degraded"
    mgr.step(sid, 1)
    mgr.store._retry_at = 0.0           # elapse the backoff
    assert mgr.health()["persistence"]["state"] == "closed"
    m2 = make_manager(state_dir=str(tmp_path))
    assert m2.get(sid).generation == 2
    assert np.array_equal(_board(m2, sid), _oracle(16, 32, 6, 2))


@pytest.mark.parametrize("policy", ["readonly", "shed"])
def test_state_degrade_policies(make_manager, tmp_path, policy):
    mgr = make_manager(state_dir=str(tmp_path), checkpoint_every=1,
                       state_degrade=policy, faults="io-write:2-99:raise")
    sid = mgr.create({"rows": 16, "cols": 32, "seed": 4})["id"]
    mgr.step(sid, 1)                    # commit fails -> degraded
    with pytest.raises(StorageDegradedError):
        mgr.step(sid, 1)
    if policy == "shed":
        with pytest.raises(StorageDegradedError):
            mgr.snapshot(sid)
    else:
        assert mgr.snapshot(sid)["generation"] == 1
    assert mgr.health()["ok"] is False
    with pytest.raises(ValueError):
        make_manager(state_dir=str(tmp_path), state_degrade="panic")
