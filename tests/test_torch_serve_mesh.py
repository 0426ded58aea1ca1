"""Serving sessions on a device mesh (``SessionManager`` with a spec's
``mesh``, ``backends/cuda_mesh.py:MeshEngine``'s serve surfaces) on the
CPU's virtual devices: the reference's ``tests/test_serve_sharded.py``
cases, run on the port's manager on 1x2 and 2x2 and held to the
reference's ``SessionManager`` on the same spec (its 8 virtual XLA CPU
devices), to the port's own 1x1 session and to the ``serial_np`` oracle.
All state is integer: every comparison is exact.

The boards are the reference's 64x96: 48 or 24 cells a shard, which the
packed engine pads to a word, so every periodic case also runs the mesh
seam band.  The coalesced batch runs on 64x128 (whole words) and on the
padded width, and counts its launches through the wrappers' recorder
(``ops/_launch.py:arm``): one a shard a pass for all the boards."""

import http.client
import json
import socket
import threading

import numpy as np
import pytest

from mpi_tpu.serve.cache import EngineCache as JaxEngineCache
from mpi_tpu.serve.session import SessionManager as JaxSessionManager
from mpi_tpu_torch.backends.cuda_mesh import MeshEngine
from mpi_tpu_torch.backends.serial_np import evolve_np
from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.models.rules import LIFE
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.ops import _launch
from mpi_tpu_torch.serve import EngineCache, SessionManager, recovery, wire
from mpi_tpu_torch.utils.hashinit import init_tile_np

R, C = 64, 96
SEED = 5
MESHES = ["1x2", "2x2"]


def _spec(mesh=None, boundary="periodic", seed=SEED, backend="cuda",
          rows=R, cols=C):
    s = {"rows": rows, "cols": cols, "backend": backend, "seed": seed,
         "boundary": boundary}
    if mesh is not None:
        s["mesh"] = mesh
    return s


def _oracle(steps, seed=SEED, boundary="periodic", rows=R, cols=C):
    return evolve_np(init_tile_np(rows, cols, seed), steps, LIFE, boundary)


def _board(mgr, sid):
    return np.asarray(mgr.snapshot_array(sid)[0], dtype=np.uint8)


@pytest.fixture()
def managers():
    """``make(kind, **kw)``: a port manager on the CPU (``"port"``) or the
    reference's (``"ref"``); every one is shut down after the test."""
    made = []

    def make(kind="port", **kw):
        if kind == "port":
            kw.setdefault("device", "cpu")
            mgr = SessionManager(**kw)
        else:
            mgr = JaxSessionManager(JaxEngineCache(max_size=8), **kw)
        made.append(mgr)
        return mgr

    yield make
    for mgr in made:
        if isinstance(mgr, SessionManager):
            mgr.shutdown()
        elif mgr.dispatcher is not None:
            mgr.dispatcher.stop()


class _Launches:
    """A recorder for ``ops/_launch.py:arm`` that counts the wrappers'
    calls by kernel (the plain versions on the CPU, the kernels on the
    card)."""

    def __init__(self):
        self.counts = {}

    def launch(self, kernel, x, meta):
        self.counts[kernel] = self.counts.get(kernel, 0) + 1
        return _launch._DISARMED

    def exchange(self, axis, pairs, shape):
        pass


# ------------------------------------------------------------ board reads


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_board_read_parity(managers, mesh):
    ours, ref = managers(), managers("ref", async_enabled=False)
    solo = ours.create(_spec("1x1"))["id"]
    sid = ours.create(_spec(mesh))["id"]
    rid = ref.create(_spec(mesh, backend="tpu"))["id"]
    eng = ours.get(sid).engine
    assert isinstance(eng, MeshEngine)
    assert f"{eng.mi}x{eng.mj}" == mesh and eng.seam
    for mgr, s in ((ours, solo), (ours, sid), (ref, rid)):
        mgr.step(s, 7)
    want = _oracle(7)
    for board in (_board(ours, solo), _board(ours, sid), _board(ref, rid)):
        np.testing.assert_array_equal(board, want)
    d = ours.describe(ours.get(sid))
    assert d["generation"] == 7 and ours.get(sid).plan_sig[5] == tuple(
        int(v) for v in mesh.split("x"))


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_viewport_crosses_shard_seams(managers, mesh):
    ours, ref = managers(), managers("ref", async_enabled=False)
    sid = ours.create(_spec(mesh))["id"]
    rid = ref.create(_spec(mesh, backend="tpu"))["id"]
    full = _board(ours, sid)
    for win in [(28, 20, 9, 30), (1, 1, 4, 4), (R - 3, C - 5, 3, 5),
                (30, 44, 6, 8)]:
        got = ours.snapshot_window(sid, *win)
        want = ref.snapshot_window(rid, *win)
        r0, c0, h, w = win
        np.testing.assert_array_equal(got[0], full[r0:r0 + h, c0:c0 + w])
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 0


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_viewport_periodic_wrap(managers, mesh):
    mgr = managers()
    sid = mgr.create(_spec(mesh))["id"]
    mgr.step(sid, 2)
    full = _board(mgr, sid)
    win, gen, _ = mgr.snapshot_window(sid, 61, 93, 7, 9)
    rows = [(61 + i) % R for i in range(7)]
    cols = [(93 + j) % C for j in range(9)]
    assert gen == 2
    np.testing.assert_array_equal(win, full[np.ix_(rows, cols)])
    dead = mgr.create(_spec(mesh, boundary="dead"))["id"]
    with pytest.raises(ConfigError):
        mgr.snapshot_window(dead, 61, 0, 7, 4)


def test_fetch_window_reads_only_the_shards_it_meets(managers):
    """One transfer a shard the window meets (the reference's
    ``shard_timer`` contract): an interior window one, a window across the
    2x2 mesh's centre four."""
    mgr = managers()
    sid = mgr.create(_spec("2x2", rows=64, cols=128))["id"]
    eng, grid = mgr.get(sid).engine, mgr.get(sid).grid
    for win, shards in [((2, 3, 5, 7), 1), ((28, 60, 8, 8), 4),
                        ((0, 0, 64, 128), 4), ((40, 10, 3, 100), 2)]:
        seen = []
        got = eng.fetch_window(grid, *win, shard_timer=seen.append)
        r0, c0, h, w = win
        np.testing.assert_array_equal(got, eng.fetch(grid)[r0:r0 + h,
                                                           c0:c0 + w])
        assert len(seen) == shards and all(t >= 0 for t in seen)


# ---------------------------------------------------------- region writes


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_region_write_parity(managers, mesh):
    ours, ref = managers(), managers("ref", async_enabled=False)
    sids = [ours.create(_spec(m, backend=b))["id"]
            for m, b in (("1x1", "cuda"), (mesh, "cuda"),
                         (None, "serial"))]
    rid = ref.create(_spec(mesh, backend="tpu"))["id"]
    patch = np.random.default_rng(40).integers(
        0, 2, size=(9, 30)).astype(np.uint8)
    for mgr, s in [(ours, s) for s in sids] + [(ref, rid)]:
        out = mgr.write_window(s, 28, 20, patch)   # crosses shard seams
        assert out["written"]
        mgr.step(s, 5)
    want = _board(ref, rid)
    for s in sids:
        np.testing.assert_array_equal(_board(ours, s), want)


@pytest.mark.parametrize("mesh", MESHES)
def test_mesh_region_write_periodic_wrap(managers, mesh):
    mgr = managers()
    sid = mgr.create(_spec(mesh))["id"]
    before = _board(mgr, sid)
    patch = np.random.default_rng(41).integers(
        0, 2, size=(6, 10)).astype(np.uint8)
    mgr.write_window(sid, 61, 92, patch)
    rows = [(61 + i) % R for i in range(6)]
    cols = [(92 + j) % C for j in range(10)]
    expect = before.copy()
    expect[np.ix_(rows, cols)] = patch
    np.testing.assert_array_equal(_board(mgr, sid), expect)
    # the pad stays dead: the padded shards' last words hold no live bit
    eng, grid = mgr.get(sid).engine, mgr.get(sid).grid
    assert eng.population(grid) == int(expect.sum())
    mgr.step(sid, 3)
    np.testing.assert_array_equal(_board(mgr, sid), evolve_np(
        expect, 3, LIFE, "periodic"))


def test_mesh_write_generation_rebase(managers):
    mgr = managers()
    sid = mgr.create(_spec("2x2"))["id"]
    mgr.step(sid, 3)
    out = mgr.write_window(sid, 0, 0, np.ones((4, 4), dtype=np.uint8),
                           generation=90)
    assert out["generation"] == 90
    assert mgr.snapshot_array(sid)[1] == 90


# ------------------------------------------------------------ checkpoints


def _shard_layout(snap):
    return sorted((sh["r0"], sh["c0"], sh["rows"], sh["cols"])
                  for sh in snap["shards"])


@pytest.mark.parametrize("mesh", MESHES)
def test_sharded_checkpoint_is_shard_form_and_restores(managers, tmp_path,
                                                       mesh):
    k, m = 5, 4
    ours_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    m1 = managers(state_dir=str(ours_dir), checkpoint_every=2)
    r1 = managers("ref", state_dir=str(ref_dir), checkpoint_every=2,
                  async_enabled=False)
    sid = m1.create(_spec(mesh))["id"]
    rid = r1.create(_spec(mesh, backend="tpu"))["id"]
    for mgr, s in ((m1, sid), (r1, rid)):
        mgr.step(s, k)
        mgr.checkpoint_now(s)
    before = _board(m1, sid)
    snap = recovery.StateStore(str(ours_dir)).load_record(sid)["snapshot"]
    want = recovery.StateStore(str(ref_dir)).load_record(rid)["snapshot"]
    assert "shards" in snap and "packed" not in snap
    assert _shard_layout(snap) == _shard_layout(want)
    cover = np.zeros((R, C), dtype=np.int32)
    for sh in snap["shards"]:
        cover[sh["r0"]:sh["r0"] + sh["rows"],
              sh["c0"]:sh["c0"] + sh["cols"]] += 1
    assert (cover == 1).all()
    np.testing.assert_array_equal(recovery.decode_grid(snap), before)
    np.testing.assert_array_equal(recovery.decode_grid(want), before)
    m1.shutdown()

    m2 = managers(state_dir=str(ours_dir))      # the restart, on the mesh
    assert m2.restored_sessions == 1
    assert isinstance(m2.get(sid).engine, MeshEngine)
    np.testing.assert_array_equal(_board(m2, sid), before)
    m2.step(sid, m)
    np.testing.assert_array_equal(_board(m2, sid), _oracle(k + m))

    # the same shard-form record onto one device
    one = tmp_path / "one"
    store = recovery.StateStore(str(one))
    snap = dict(snap, generation=k)
    store.save("s1", _spec("1x1"), k, snap)
    m3 = managers(state_dir=str(one))
    assert m3.restored_sessions == 1 and m3.get("s1").engine.mi == 1
    np.testing.assert_array_equal(_board(m3, "s1"), before)
    m3.step("s1", m)
    np.testing.assert_array_equal(_board(m3, "s1"), _oracle(k + m))


def test_legacy_full_grid_record_restores_on_mesh(managers, tmp_path):
    store = recovery.StateStore(str(tmp_path))
    grid = init_tile_np(R, C, SEED)
    snap = recovery.encode_grid(grid)
    snap["generation"] = 0
    store.save("s1", _spec("2x2"), 0, snap)
    mgr = managers(state_dir=str(tmp_path))
    assert mgr.restored_sessions == 1
    assert isinstance(mgr.get("s1").engine, MeshEngine)
    np.testing.assert_array_equal(_board(mgr, "s1"), grid)
    mgr.step("s1", 3)
    np.testing.assert_array_equal(_board(mgr, "s1"), _oracle(3))


def test_release_adopt_parity_shard_records(managers, tmp_path):
    m2 = managers(state_dir=str(tmp_path))      # the successor, idle
    m1 = managers(state_dir=str(tmp_path))
    sid = m1.create(_spec("1x2"))["id"]
    m1.step(sid, 6)
    m1.checkpoint_now(sid)
    before = _board(m1, sid)
    m1.release(sid)
    with pytest.raises(KeyError):
        m1.get(sid)
    assert m2.adopt_session(sid)
    assert isinstance(m2.get(sid).engine, MeshEngine)
    np.testing.assert_array_equal(_board(m2, sid), before)
    m2.step(sid, 2)
    np.testing.assert_array_equal(_board(m2, sid), _oracle(8))
    assert not m2.adopt_session("nope")


# ------------------------------------------------------------ delta stream


def test_delta_stream_reconstruction_matches_keyframes(managers):
    """Over the aio front: a windowed delta stream of a 2x2 session folded
    through ``wire.apply_delta`` equals, at every generation, the frame
    the keyframe stream ships and the board's window."""
    from mpi_tpu_torch.serve.aio import make_aio_server

    mgr = managers()
    srv = make_aio_server(port=0, manager=mgr)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    host, port = srv.server_address[:2]
    socks = []

    def call(method, path, body=None):
        c = http.client.HTTPConnection(host, port, timeout=60)
        c.request(method, path,
                  body=json.dumps(body).encode() if body else None)
        resp = c.getresponse()
        raw = resp.read()
        assert resp.status == 200, (resp.status, raw[:200])
        c.close()
        return raw

    def open_stream(query):
        s = socket.create_connection((host, port), timeout=60)
        s.sendall(f"GET {query} HTTP/1.1\r\nHost: x\r\n\r\n".encode())
        buf = b""
        while b"\r\n\r\n" not in buf:
            buf += s.recv(65536)
        socks.append(s)
        return s, bytearray(buf.split(b"\r\n\r\n", 1)[1])

    def read_frame(s, buf):
        while b"\r\n" not in buf:
            buf += s.recv(65536)
        head, rest = bytes(buf).split(b"\r\n", 1)
        size = int(head, 16)
        buf[:] = rest
        while len(buf) < size + 2:
            buf += s.recv(65536)
        frame = bytes(buf[:size])
        buf[:] = buf[size + 2:]
        return wire.decode_frame(frame)

    try:
        sid = mgr.create(_spec("2x2"))["id"]
        window = (28, 20, 16, 32)                 # crosses shard seams
        q = (f"x0={window[0]}&y0={window[1]}"
             f"&h={window[2]}&w={window[3]}&every=1")
        sk, kbuf = open_stream(f"/stream/{sid}?{q}")
        sd, dbuf = open_stream(f"/stream/{sid}?{q}&delta=1")
        kgrid, _ = read_frame(sk, kbuf)
        dgrid, dmeta = read_frame(sd, dbuf)
        assert not dmeta["is_delta"]
        np.testing.assert_array_equal(kgrid, dgrid)
        recon = dgrid
        for gen in range(1, 5):
            call("POST", f"/sessions/{sid}/step", {"steps": 1})
            kgrid, kmeta = read_frame(sk, kbuf)
            dg, dm = read_frame(sd, dbuf)
            assert kmeta["generation"] == dm["generation"] == gen
            recon = dg if dg is not None \
                else wire.apply_delta(recon, dm["tiles"])
            np.testing.assert_array_equal(recon, kgrid)
        win, _, _ = mgr.snapshot_window(sid, *window)
        np.testing.assert_array_equal(recon, win)
        r0, c0, h, w = window
        np.testing.assert_array_equal(win, _oracle(4)[r0:r0 + h,
                                                      c0:c0 + w])
    finally:
        for s in socks:
            try:
                s.close()
            except OSError:
                pass
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=10)


# ---------------------------------------------------------- coalesced rounds


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
        t.join(timeout=120)
        assert not t.is_alive()
    if errors:
        raise errors[0]


@pytest.mark.parametrize("cols,mesh", [(128, "2x2"), (96, "1x2")],
                         ids=["words-2x2", "padded-seam-1x2"])
def test_coalesced_batch_on_a_mesh_is_one_launch_a_shard(managers, cols,
                                                         mesh):
    """Four sessions stepped at once coalesce into one batched step on the
    mesh: each board equals its oracle and the reference manager's, and
    the round launches the engine's kernel once a shard a pass for all
    four boards (the seam band once a pass), not once a board."""
    ours = managers(cache=EngineCache(max_size=4), async_enabled=False,
                    batch_window_ms=1000.0)
    ref = managers("ref", async_enabled=False, batch_window_ms=1000.0)
    seeds = (1, 2, 3, 4)
    sids = [ours.create(_spec(mesh, seed=s, cols=cols))["id"]
            for s in seeds]
    rids = [ref.create(_spec(mesh, seed=s, cols=cols, backend="tpu"))["id"]
            for s in seeds]
    eng = ours.get(sids[0]).engine
    _step_all_concurrently(ours, sids)          # warms (1, 4)
    rec = _Launches()
    previous = _launch.arm(rec)
    try:
        _step_all_concurrently(ours, sids)
    finally:
        _launch.arm(previous)
    _step_all_concurrently(ref, rids)
    _step_all_concurrently(ref, rids)
    shards = eng.mi * eng.mj
    assert eng.batched_step_calls == 2 and eng.step_calls == 0
    assert rec.counts.get(eng.kernel_id, 0) == shards
    assert rec.counts.get("seam", 0) == (1 if eng.seam else 0)
    assert rec.counts.get("K2", 0) == 0 or eng.kernel_id == "K2"
    assert ours.stats()["batch"]["coalesced_calls"] \
        == ref.stats()["batch"]["coalesced_calls"] == 2
    for s, r, seed in zip(sids, rids, seeds):
        want = _oracle(2, seed=seed, cols=cols)
        np.testing.assert_array_equal(_board(ours, s), want)
        np.testing.assert_array_equal(_board(ref, r), want)


def test_async_tickets_on_a_mesh(managers):
    """Tickets of mixed depths on 2x2 sessions: the dispatcher's unit
    rounds (batched while the cohort holds) land on the oracle."""
    mgr = managers(batch_window_ms=50.0)
    sids = [mgr.create(_spec("2x2", seed=s))["id"] for s in (1, 2, 3)]
    tickets = [mgr.step_async(s, n)["ticket"]
               for s, n in zip(sids, (1, 2, 5))]
    for t in tickets:
        assert mgr.ticket_result(t, wait=True)["status"] == "done"
    for s, n, seed in zip(sids, (1, 2, 5), (1, 2, 3)):
        np.testing.assert_array_equal(_board(mgr, s), _oracle(n, seed=seed))


# ------------------------------------------------------------- halo probe


def test_halo_probe_samples_the_serving_mesh(managers):
    """The devmem sampler times one ghost-ring exchange on the first live
    engine's mesh, ``mpi_tpu_halo_exchange_seconds{mesh="1x2"}``."""
    obs = Obs()
    mgr = managers(cache=EngineCache(max_size=4), obs=obs)
    obs.arm_telemetry(manager=mgr, start=False)
    obs.arm_flight(manager=mgr)
    mgr.create(_spec("1x1"))
    obs.telemetry.sample_once()
    hist = obs.devmem.halo_hist
    assert hist.count(mesh="1x2") == 0
    mgr.create(_spec("1x2"))
    obs.telemetry.sample_once()
    obs.telemetry.sample_once()
    assert hist.count(mesh="1x2") == 2
    assert obs.devmem.stats()["errors"] == 0


def test_halo_probe_counts_only_its_own_exchange(managers, monkeypatch):
    """A sample is the probe's own time: a slow warm-up and whatever ran
    on the mesh before the call stay out of it (``obs/devmem.py:
    time_probe``).  The fake probe sleeps 0.3 s on its warming call and
    0.02 s on each timed one."""
    import time as _time

    from mpi_tpu_torch.obs import devmem
    from mpi_tpu_torch.parallel import step as pstep

    calls = []

    def fake_probe(mesh, boundary, radius=1, axes=None):
        def probe(shards):
            calls.append(len(shards))
            _time.sleep(0.3 if len(calls) == 1 else 0.02)
            return shards
        return probe

    monkeypatch.setattr(pstep, "make_halo_probe", fake_probe)
    obs = Obs()
    mgr = managers(cache=EngineCache(max_size=4), obs=obs)
    obs.arm_telemetry(manager=mgr, start=False)
    obs.arm_flight(manager=mgr)
    sid = mgr.create(_spec("1x2"))["id"]
    obs.telemetry.sample_once()
    mgr.step(sid, 3)  # serving work between two samples
    obs.telemetry.sample_once()
    hist = obs.devmem.halo_hist
    assert calls == [1, 1, 1]
    assert hist.count(mesh="1x2") == 2
    assert 0.04 <= hist.total_sum() < 0.3
    assert devmem.HALO_PROBE_TILE == 128


# ------------------------------------------------------- the mesh's devices


@pytest.mark.parametrize("shape,devices,want", [
    ((1, 1), None, 1),
    ((2, 2), None, 4),
    ((2, 4), None, 8),
    ((1, 2), ["cpu"] * 4, 2),
    ((1, 1), ["cpu"] * 4, 1),
], ids=["1x1", "2x2-virtual", "2x4-virtual", "1x2-prefix", "1x1-own"])
def test_mesh_over_places_a_spec_mesh(shape, devices, want):
    """``parallel/mesh.py:mesh_over``, the one placement that sessions and
    the tuner share: 1x1 is the device itself; a larger shape spans the
    given list (a prefix when it names one device several times) or the
    CPU's virtual devices; the shape the engine sees is the one asked."""
    import torch

    from mpi_tpu_torch.parallel.mesh import mesh_over

    mesh = mesh_over(shape, devices and [torch.device(d) for d in devices],
                     "cpu")
    assert mesh.dims == shape and mesh.size == want
    assert all(d == torch.device("cpu") for row in mesh.devices
               for d in row)


def test_mesh_over_refuses_what_does_not_fit():
    """A mesh larger than the devices is refused with the reference's
    ``make_mesh`` message, on the virtual devices as on a given list."""
    import torch

    from mpi_tpu_torch.parallel.mesh import mesh_over

    with pytest.raises(ValueError, match=r"mesh shape \(3, 3\) needs 9 "
                                         r"devices, have 8"):
        mesh_over((3, 3), None, "cpu")
    with pytest.raises(ValueError, match=r"needs 4 devices, have 2"):
        mesh_over((2, 2), [torch.device("cpu")] * 2, "cpu")
