"""The port's durable state plane beyond its restore path: the offline
scrub (``mpi_tpu_torch/serve/recovery.py:scan_state_dir`` and its entry
point ``python -m mpi_tpu_torch.serve.scrub``) on state dirs that the
port's ``StateStore`` wrote, and the cluster degraded-bit and
partial-corruption failover paths: the reference's
``tests/test_serve_durability.py`` scrub and cluster cases, against the
port's ``SessionManager(device="cpu")`` (``cuda`` sessions step the
kernels' plain versions) with boards held against the reference's serial
oracle.  The scrub's flags, report and exit codes are the reference's
``tools/scrub.py``'s.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

from mpi_tpu.backends.serial_np import evolve_np
from mpi_tpu.models.rules import LIFE
from mpi_tpu.utils.hashinit import init_tile_np
from mpi_tpu_torch.cluster import ClusterNode
from mpi_tpu_torch.serve.cache import EngineCache
from mpi_tpu_torch.serve.faults import FaultInjector
from mpi_tpu_torch.serve.httpd import make_server
from mpi_tpu_torch.serve.recovery import StateStore, scan_state_dir
from mpi_tpu_torch.serve.session import SessionManager

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle(rows, cols, seed, steps, boundary="periodic", rule=LIFE):
    return evolve_np(init_tile_np(rows, cols, seed), steps, rule, boundary)


def _grid_of(snap):
    return np.array([[int(c) for c in row] for row in snap["grid"]],
                    dtype=np.uint8)


# --------------------------------------------------------------- scrub


def _scrub(*args):
    return subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.serve.scrub", *args],
        capture_output=True, text=True, timeout=120, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_scrub_reports_repairs_and_exit_codes(tmp_path):
    store = StateStore(str(tmp_path), checkpoint_every=1)
    spec = {"rows": 16, "cols": 16, "backend": "cuda", "seed": 1}
    store.save("s1", spec, 0, None)
    g = init_tile_np(16, 16, 1)
    for gen in (1, 2, 3):
        store.commit_step("s1", spec, gen, None, grid=g)
    store.save("s2", spec, 0, None)
    raw = bytearray((tmp_path / "s2.json").read_bytes())
    raw[8] ^= 0xFF
    (tmp_path / "s2.json").write_bytes(bytes(raw))
    with open(tmp_path / "s1.journal", "ab") as f:
        f.write(b"\x00torn tail")
    (tmp_path / "s3.json.tmp7").write_bytes(b"interrupted")
    (tmp_path / "routing-ab12cd.json").write_text('{"v": 2, "routes": {}}')

    r1 = _scrub(str(tmp_path))
    assert r1.returncode == 1, r1.stdout + r1.stderr
    assert "torn tail" in r1.stdout and "stale tmp" in r1.stdout
    r2 = _scrub(str(tmp_path), "--repair")
    assert r2.returncode == 0, r2.stdout + r2.stderr
    r3 = _scrub(str(tmp_path), "--json")
    assert r3.returncode == 0, r3.stdout + r3.stderr
    rpt = json.loads(r3.stdout)
    assert rpt["clean"] and rpt["records_ok"] >= 1
    assert rpt["journal_entries"] == 3
    # quarantined, not deleted; routing table untouched
    assert any(f.name.startswith("s2.corrupt-") for f in tmp_path.iterdir())
    assert (tmp_path / "routing-ab12cd.json").exists()
    # repaired dir restores: s1 at its journaled generation, s2 lost
    # loudly (quarantined), never garbage
    store2 = StateStore(str(tmp_path), checkpoint_every=1)
    recs = store2.load_records()
    assert [r["id"] for r in recs] == ["s1"]
    assert recs[0]["generation"] == 3


def test_scrub_internal_error_exits_2(tmp_path):
    f = tmp_path / "not-a-dir"
    f.write_text("x")
    r = _scrub(str(f))
    assert r.returncode == 2
    assert "internal error" in r.stderr


def test_scan_state_dir_repair_truncates_torn_tail_in_place(tmp_path):
    store = StateStore(str(tmp_path), checkpoint_every=1)
    spec = {"rows": 16, "cols": 16, "backend": "cuda", "seed": 2}
    store.save("s1", spec, 0, None)
    g = init_tile_np(16, 16, 2)
    store.commit_step("s1", spec, 1, None, grid=g)
    jpath = tmp_path / "s1.journal"
    good = jpath.read_bytes()
    jpath.write_bytes(good + good[: len(good) // 2])    # torn re-append
    rpt = scan_state_dir(str(tmp_path), repair=True)
    assert rpt["torn_tails"] == 1
    assert jpath.read_bytes() == good, "repair must cut exactly the tail"
    assert scan_state_dir(str(tmp_path))["clean"]


# ------------------------------------------------------------- cluster

# the in-process pair harness from tests/test_torch_cluster.py, trimmed
# to what the durability paths need
class _Node:
    def __init__(self, state_dir=None, faults=None):
        self.mgr = SessionManager(EngineCache(max_size=4), batching=False,
                                  state_dir=state_dir, faults=faults,
                                  device="cpu")
        self.srv = make_server("127.0.0.1", 0, self.mgr)
        host, port = self.srv.server_address[:2]
        self.addr = f"{host}:{port}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.node = None

    def join(self, peers, state_dir=None, **kw):
        self.node = ClusterNode(self.addr, peers, self.mgr,
                                interval_s=3600.0, state_dir=state_dir,
                                **kw)
        self.mgr.attach_cluster(self.node)
        self.srv.core.cluster = self.node
        return self.node

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        self.mgr.shutdown()


def test_gossip_carries_the_degraded_bit(tmp_path):
    state = str(tmp_path / "shared")
    a, b = _Node(state_dir=state), _Node(state_dir=state)
    a.join([b.addr], state_dir=state)
    b.join([a.addr], state_dir=state)
    try:
        assert a.node.digest()["persist_degraded"] is False
        b.mgr.store._io_fail(None)              # b's disk dies
        assert b.node.digest()["persist_degraded"] is True
        b.node.gossip_now()
        assert a.node.peers[b.addr].persist_degraded is True
        b.mgr.store._io_ok(None)                # heals
        b.node.gossip_now()
        assert a.node.peers[b.addr].persist_degraded is False
    finally:
        a.close()
        b.close()


def test_failover_refuses_adoption_from_degraded_peer(tmp_path):
    """A dead peer whose last gossiped persistence bit was degraded has
    known-unwritten checkpoints: adopting its records would silently
    serve stale boards, so failover counts them lost — loudly — and
    leaves the state dir to the scrub runbook."""
    state = str(tmp_path / "shared")
    a, b = _Node(state_dir=state), _Node(state_dir=state)
    a.join([b.addr], state_dir=state, down_after_s=0.05, dead_after_s=0.12)
    b.join([a.addr], state_dir=state, down_after_s=0.05, dead_after_s=0.12)
    try:
        # place sessions directly on b (manager-level create pins them)
        for i in range(2):
            b.mgr.create({"rows": 16, "cols": 16, "backend": "cuda",
                          "seed": i})
        orphans = sorted(b.mgr.session_ids())
        assert orphans
        b.mgr.store._io_fail(None)              # b's disk dies...
        b.node.gossip_now()                     # ...and a hears about it
        assert a.node.peers[b.addr].persist_degraded is True
        b.close()
        time.sleep(0.15)
        assert a.node.check_membership() == [b.addr]
        assert a.node.failover_adopted == 0
        assert a.node.failover_lost >= len(orphans)
        assert not (set(orphans) & set(a.mgr.session_ids())), \
            "degraded peer's sessions must NOT be silently adopted"
        assert a.node._dead[b.addr]["persist_degraded"] is True
    finally:
        a.close()
        b.close()


def test_failover_adopts_good_sessions_from_partially_corrupt_dir(tmp_path):
    """Some of the dead peer's records rotted, some are fine: the bad
    ones quarantine and count lost, every good one is adopted
    bit-identically — partial corruption never blocks the salvageable
    majority."""
    state = str(tmp_path / "shared")
    a, b = _Node(state_dir=state), _Node(state_dir=state)
    a.join([b.addr], state_dir=state, down_after_s=0.05, dead_after_s=0.12)
    b.join([a.addr], state_dir=state, down_after_s=0.05, dead_after_s=0.12)
    try:
        sids, seeds, i = [], {}, 0
        while len(sids) < 3:
            sid = b.mgr.create({"rows": 16, "cols": 16,
                                "backend": "cuda", "seed": i})["id"]
            seeds[sid] = i
            sids.append(sid)
            i += 1
        gens = {}
        for j, sid in enumerate(sids):
            b.mgr.step(sid, 2 + j)
            gens[sid] = 2 + j
        a.node.gossip_now()
        b.node.gossip_now()
        victim = sids[0]
        # rot the victim's whole chain: head + every ancestor
        for p in (tmp_path / "shared").iterdir():
            if p.name.startswith(f"{victim}."):
                p.write_bytes(os.urandom(64))
        b.close()
        time.sleep(0.15)
        assert a.node.check_membership() == [b.addr]
        assert a.node.failover_lost >= 1
        assert a.node.failover_adopted == len(sids) - 1
        for sid in sids[1:]:
            assert sid in set(a.mgr.session_ids())
            snap = a.mgr.snapshot(sid)
            assert snap["generation"] == gens[sid]
            assert np.array_equal(
                _grid_of(snap), _oracle(16, 16, seeds[sid], gens[sid]))
        assert victim not in set(a.mgr.session_ids())
    finally:
        a.close()
        b.close()


def test_drain_under_io_write_raise_keeps_batch_local(tmp_path):
    """The drain checkpoint must land before handoff — with the disk
    raising on every write, the batch stays local, still served, zero
    lost generations."""
    state = str(tmp_path / "shared")
    a, b = _Node(state_dir=state), _Node(state_dir=state)
    a.join([b.addr], state_dir=state)
    b.join([a.addr], state_dir=state)
    try:
        sid = a.mgr.create({"rows": 16, "cols": 16, "backend": "cuda",
                            "seed": 3})["id"]
        a.mgr.step(sid, 4)
        inj = FaultInjector.from_spec("io-write:1-999:raise")
        a.mgr.store.fault_hook = inj.io_hook
        out = a.node.drain()
        assert out["ok"] is False and out["errors"], out
        assert sid not in out["handoffs"].get(b.addr, []), out
        assert sid in set(a.mgr.session_ids()), "batch must stay local"
        snap = a.mgr.snapshot(sid)
        assert snap["generation"] == 4
        assert np.array_equal(_grid_of(snap), _oracle(16, 16, 3, 4))
        assert sid not in set(b.mgr.session_ids())
    finally:
        a.close()
        b.close()
