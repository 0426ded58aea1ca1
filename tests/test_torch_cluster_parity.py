"""The port's cluster package held against the reference's, on the CPU.

* **Placement and gossip arithmetic.**  For 2000 seeded keys over the
  same node lists, ``HashRing.owner``; ``RoutingTable`` round trips
  (epochs, a v1 file's upgrade, junk files and junk entries);
  ``node_tag``; ``merge_totals`` over seeded ledger totals; and
  ``digest``/``apply_digest`` folding the same member maps and routes.
  All equal the reference's.
* **One scripted request sequence** against a two-node reference pair
  (``backend: "tpu"`` on the JAX CPU mesh, 1x1) and a two-node port pair
  (``SessionManager(device="cpu")``, ``backend: "cuda"``, the kernels'
  plain versions), each pair over its own shared state dir: creates
  placed by the ring, steps proxied to the owner and served directly,
  binary frames through the proxy, a ticket routed by its tag, a stream
  redirected with 307, the one-hop guard, ``/cluster``'s endpoints and
  their structured errors, a drain, and a dead peer's 503s with
  ``Retry-After`` and its tickets' structured 404s.  Status codes,
  ``Retry-After`` and ``Location`` are equal, binary frames byte for
  byte, and JSON equal apart from the measured fields of
  ``test_torch_http.py``'s ``MEASURED`` plus the few named below, with
  each side's node addresses, node tags and session ids masked (the ring
  hashes addresses, so the two pairs place differently: the script
  hunts, on each side, a session the first node allocates and the
  second owns, and one the first node keeps).
* **The cluster ``/metrics`` families**: ``FAMILIES["cluster"]`` equals
  the reference's ``cluster_families()`` extraction, and both pairs'
  scrapes carry them with equal help strings and label names.

No tolerance: every compared value is an integer, a string or a byte.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import sys
import threading

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir,
                                "tools"))
from obs_smoke import parse_prometheus  # noqa: E402

from mpi_tpu.analysis.obsreg import cluster_families  # noqa: E402
from mpi_tpu.cluster import ClusterNode as JaxClusterNode  # noqa: E402
from mpi_tpu.cluster import HashRing as JaxHashRing  # noqa: E402
from mpi_tpu.cluster import RoutingTable as JaxRoutingTable  # noqa: E402
from mpi_tpu.cluster import node_tag as jax_node_tag  # noqa: E402
from mpi_tpu.cluster.proxy import FORWARDED_HEADER  # noqa: E402
from mpi_tpu.obs import Obs as JaxObs  # noqa: E402
from mpi_tpu.obs.ledger import merge_totals as jax_merge_totals  # noqa: E402
from mpi_tpu.serve.cache import EngineCache as JaxEngineCache  # noqa: E402
from mpi_tpu.serve.httpd import make_server as jax_make_server  # noqa: E402
from mpi_tpu.serve.session import SessionManager as JaxManager  # noqa: E402
from mpi_tpu_torch.cluster import (  # noqa: E402
    ClusterNode, HashRing, RoutingTable, node_tag,
)
from mpi_tpu_torch.obs import Obs  # noqa: E402
from mpi_tpu_torch.obs.ledger import merge_totals  # noqa: E402
from mpi_tpu_torch.obs.metrics import FAMILIES  # noqa: E402
from mpi_tpu_torch.serve import wire  # noqa: E402
from mpi_tpu_torch.serve.cache import EngineCache  # noqa: E402
from mpi_tpu_torch.serve.httpd import make_server  # noqa: E402
from mpi_tpu_torch.serve.session import SessionManager  # noqa: E402

from test_torch_http import MEASURED, PORT_ONLY, _families  # noqa: E402

GRID = wire.GRID_MEDIA_TYPE
# beyond MEASURED: the gossip incarnation (a wall-clock stamp), the
# digest sequence (every digest a node built, /cluster/gossip replies
# included) and a peer's heartbeat age
CLUSTER_MEASURED = {"inc", "seq", "last_seen_age_s"}


# ------------------------------------------------ placement + arithmetic


NODE_LISTS = [
    ["h1:8000"],
    ["h1:8000", "h2:8000"],
    ["h1:8000", "h2:8000", "h3:8000"],
    ["127.0.0.1:41001", "127.0.0.1:41002", "127.0.0.1:41003",
     "10.0.0.7:8000", "[::1]:9000"],
]


def _keys(n=2000, seed=11):
    rng = np.random.default_rng(seed)
    tags = [f"{int(t):06x}" for t in rng.integers(0, 1 << 24, size=16)]
    return [f"s{int(rng.integers(1, 10 ** 6))}-{tags[i % 16]}"
            for i in range(n)]


@pytest.mark.parametrize("nodes", NODE_LISTS,
                         ids=[str(len(n)) for n in NODE_LISTS])
def test_ring_owner_equals_the_references(nodes):
    ours, ref = HashRing(nodes), JaxHashRing(nodes)
    assert ours.nodes == ref.nodes
    keys = _keys()
    assert [ours.owner(k) for k in keys] == [ref.owner(k) for k in keys]


def test_node_tag_equals_the_references():
    addrs = [f"127.0.0.1:{p}" for p in range(40000, 42000)]
    assert [node_tag(a) for a in addrs] == [jax_node_tag(a) for a in addrs]


def _table_ops(cls, path, keys):
    t = cls(path)
    rng = np.random.default_rng(3)
    for k in keys[:300]:
        t.record(k, f"h{int(rng.integers(1, 4))}:8000")
    t.update({k: (f"h{int(rng.integers(1, 4))}:8000",
                  int(rng.integers(0, 9))) for k in keys[200:500]})
    t.update({keys[0]: "h9:8000", keys[1]: ["h8:8000", 99],
              keys[2]: ("h7:8000", -1), keys[3]: 42})     # junk included
    return t


def test_routing_table_round_trips_equal_the_references(tmp_path):
    keys = _keys()
    ours = _table_ops(RoutingTable, str(tmp_path / "ours.json"), keys)
    ref = _table_ops(JaxRoutingTable, str(tmp_path / "ref.json"), keys)
    assert ours.snapshot_entries() == ref.snapshot_entries()
    assert ours.snapshot() == ref.snapshot() and len(ours) == len(ref)
    # each side reloads the other's file to the same entries
    assert (RoutingTable(str(tmp_path / "ref.json")).snapshot_entries()
            == ref.snapshot_entries())
    assert (JaxRoutingTable(str(tmp_path / "ours.json")).snapshot_entries()
            == ours.snapshot_entries())
    # a v1 file (flat sid -> node) upgrades to epoch-0 entries
    v1 = {k: f"h{i % 3}:8000" for i, k in enumerate(keys[:50])}
    (tmp_path / "v1.json").write_text(json.dumps(v1))
    shutil.copy(tmp_path / "v1.json", tmp_path / "v1b.json")
    a = RoutingTable(str(tmp_path / "v1.json"))
    b = JaxRoutingTable(str(tmp_path / "v1b.json"))
    assert a.snapshot_entries() == b.snapshot_entries()
    assert all(e == 0 for _, e in a.snapshot_entries().values())
    # junk files: each resets to an empty table, counted the same way
    for i, junk in enumerate([b"{nope", b"[1, 2]", b"\xff\xfe",
                              b'{"v": 2, "routes": 7}',
                              b'{"v": 2, "routes": {"s1": [3]}}']):
        pa, pb = tmp_path / f"j{i}a.json", tmp_path / f"j{i}b.json"
        pa.write_bytes(junk)
        pb.write_bytes(junk)
        a, b = RoutingTable(str(pa)), JaxRoutingTable(str(pb))
        assert a.snapshot_entries() == b.snapshot_entries(), junk
        assert a.resets == b.resets, junk


def _ledger_totals(rng):
    return {
        "syncs": int(rng.integers(0, 10 ** 6)),
        "generations": int(rng.integers(0, 10 ** 9)),
        "cells": int(rng.integers(0, 10 ** 15)),
        "device_s": float(rng.integers(0, 10 ** 6)) / 1024.0,
        "host_s": float(rng.integers(0, 10 ** 6)) / 1024.0,
        "flops": float(rng.integers(0, 10 ** 12)),
        "sessions": int(rng.integers(0, 100)),
    }


def test_merge_totals_equals_the_references():
    rng = np.random.default_rng(5)
    for n in (0, 1, 2, 3, 7):
        snaps = [_ledger_totals(rng) for _ in range(n)]
        assert merge_totals(snaps) == jax_merge_totals(snaps)


class _FakeCache:
    def __init__(self):
        self.remote = {}

    def breaker_stats(self):
        return {"open": ["64x64/x/periodic/mesh1x1/life"]}

    def set_remote_open(self, peer, labels, ttl_s):
        self.remote[peer] = (list(labels), ttl_s)


class _FakeMgr:
    """The manager surface a ClusterNode reads, without sessions."""

    def __init__(self, sids):
        self._sids = list(sids)
        self.cache = _FakeCache()
        self.obs = None
        self.store = None
        self.faults = None

    def session_ids(self):
        return list(self._sids)

    def adopt_session(self, sid):
        return False                    # no state dir: nothing to adopt


def _digest_fold(cls):
    mgr_a = _FakeMgr(["s1-aaaaaa", "s2-aaaaaa"])
    mgr_b = _FakeMgr(["s7-bbbbbb"])
    a = cls("h1:8000", ["h2:8000", "h3:8000"], mgr_a, interval_s=3600.0)
    b = cls("h2:8000", ["h1:8000", "h3:8000"], mgr_b, interval_s=3600.0)
    b.record_route("s9-cccccc", "h3:8000")
    d = b.digest()
    applied = [a.apply_digest(d), a.apply_digest(d)]   # duplicate: stale
    # a member map naming h3 dead at a higher epoch, and one junk entry
    d2 = b.digest()
    d2["members"] = dict(d2["members"], **{"h3:8000": ["dead", 5],
                                           "h4:8000": ["zombie", 1]})
    d2["epoch"] = 5
    applied.append(a.apply_digest(d2))
    applied.append(a.apply_digest({"node": "h9:8000", "seq": 1}))
    info = a.info()
    for k in ("peers",):
        for st in info[k].values():
            st.pop("last_seen_age_s", None)
    info["gossip"].pop("interval_s")
    return (applied, a.table.snapshot_entries(), a.ring.nodes,
            a._members_copy(), a.epoch, info, mgr_a.cache.remote,
            sorted(k for k in d if k not in ("inc",)))


def test_digest_and_apply_digest_equal_the_references():
    assert _digest_fold(ClusterNode) == _digest_fold(JaxClusterNode)


# ------------------------------------------------ the scripted pair


class _Node:
    def __init__(self, side, state_dir):
        if side == "ref":
            self.obs = JaxObs()
            self.mgr = JaxManager(JaxEngineCache(max_size=4),
                                  batching=False, obs=self.obs,
                                  state_dir=state_dir)
            mk = jax_make_server
        else:
            self.obs = Obs()
            self.mgr = SessionManager(EngineCache(max_size=4),
                                      batching=False, obs=self.obs,
                                      state_dir=state_dir, device="cpu")
            mk = make_server
        self.side = side
        self.srv = mk("127.0.0.1", 0, self.mgr)
        host, port = self.srv.server_address[:2]
        self.addr = f"{host}:{port}"
        self.thread = threading.Thread(target=self.srv.serve_forever,
                                       daemon=True)
        self.thread.start()
        self.node = None
        self.closed = False

    def join(self, peers, state_dir):
        cls = JaxClusterNode if self.side == "ref" else ClusterNode
        self.node = cls(self.addr, peers, self.mgr, interval_s=3600.0,
                        down_after_s=60.0, dead_after_s=120.0,
                        proxy_backoff_s=0.0, state_dir=state_dir,
                        obs=self.obs)
        self.mgr.attach_cluster(self.node)
        self.srv.core.cluster = self.node

    def close(self):
        if self.closed:
            return
        self.closed = True
        self.srv.shutdown()
        self.srv.server_close()
        self.thread.join(timeout=10)
        if self.side == "port":
            self.mgr.shutdown()


def _send(addr, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection(addr, timeout=120)
    data = json.dumps(body).encode() if isinstance(body, dict) else body
    conn.request(method, path, body=data, headers=dict(headers or {}))
    resp = conn.getresponse()
    raw = resp.read()
    out = (resp.status, resp.getheader("Content-Type"),
           resp.getheader("Retry-After"), resp.getheader("Location"), raw)
    conn.close()
    return out


def _life(backend, seed):
    spec = {"rows": 64, "cols": 64, "backend": backend, "seed": seed}
    if backend == "tpu":
        spec["mesh"] = "1x1"
    return spec


def _run_pair(side, root):
    """Serve the cluster script from one side's pair; returns
    ({label: reply}, masks) with every server and manager shut down."""
    backend = "tpu" if side == "ref" else "cuda"
    state = os.path.join(root, side)
    os.makedirs(state)
    a, b = _Node(side, state), _Node(side, state)
    a.join([b.addr], state)
    b.join([a.addr], state)
    out = {}
    try:
        # at front a, X is allocated and owned by b, Y kept by a.  The
        # ring places ids by hash, so a's allocator skips the ids the
        # script does not need (no session, no route) before each create
        x = y = None
        while x is None or y is None:
            nxt = f"s{a.node._sid_next}-{a.node.tag}"
            owner = a.node.owner_addr(nxt)
            if (x is None and owner == b.addr) or (y is None
                                                   and owner == a.addr):
                st, _, _, _, raw = _send(a.addr, "POST", "/sessions",
                                         _life(backend, 7))
                assert st == 200 and json.loads(raw)["id"] == nxt, raw
                if owner == b.addr:
                    x = nxt
                else:
                    y = nxt
            else:
                a.node.new_session_id()
        a.node.gossip_now()
        masks = [(state, "<STATE>"), (x, "<X>"), (y, "<Y>"),
                 (a.addr, "<A>"), (b.addr, "<B>"), (a.node.tag, "<a>"),
                 (b.node.tag, "<b>")]
        frame = wire.encode_frame(
            np.random.default_rng(21).integers(0, 2, (64, 64)).astype(
                np.uint8), generation=10)
        script = [
            ("cluster-info-a", a, "GET", "/cluster", None, {}),
            ("step-x-proxied", a, "POST", f"/sessions/{x}/step",
             {"steps": 8}, {}),
            ("step-x-owner", b, "POST", f"/sessions/{x}/step",
             {"steps": 8}, {}),
            ("frame-x-proxied", a, "GET", f"/sessions/{x}/snapshot", None,
             {"Accept": GRID}),
            ("frame-x-owner", b, "GET", f"/sessions/{x}/snapshot", None,
             {"Accept": GRID}),
            ("json-x-proxied", a, "GET", f"/sessions/{x}/snapshot", None,
             {}),
            ("density-x-proxied", a, "GET", f"/sessions/{x}/density", None,
             {}),
            ("describe-x-proxied", a, "GET", f"/sessions/{x}", None, {}),
            ("write-x-proxied", a, "PUT", f"/sessions/{x}/board", frame,
             {"Content-Type": GRID}),
            ("step-x-after-write", a, "POST", f"/sessions/{x}/step",
             {"steps": 3}, {}),
            ("frame-x-after-write", a, "GET", f"/sessions/{x}/snapshot",
             None, {"Accept": GRID}),
            ("write-y-proxied", b, "PUT", f"/sessions/{y}/board", frame,
             {"Content-Type": GRID}),
            ("step-y-proxied", b, "POST", f"/sessions/{y}/step",
             {"steps": 5}, {}),
            ("frame-y-proxied", b, "GET", f"/sessions/{y}/snapshot", None,
             {"Accept": GRID}),
            ("async-x", a, "POST", f"/sessions/{x}/step?async=1",
             {"steps": 2}, {}),
            ("result-x-by-tag", a, "GET", "/result/t1@<b>?wait=1", None,
             {}),
            ("result-x-frame", a, "GET", "/result/t1@<b>", None,
             {"Accept": GRID}),
            ("unknown-ticket-peer", a, "GET", "/result/t99@<b>", None, {}),
            ("unknown-ticket-stranger", a, "GET", "/result/t99@ffffff",
             None, {}),
            ("stream-x-redirect", a, "GET", f"/stream/{x}?every=1", None,
             {}),
            ("one-hop-guard", a, "GET", f"/sessions/{x}", None,
             {FORWARDED_HEADER: "probe"}),
            ("unknown-session", a, "GET", "/sessions/s999-<b>/snapshot",
             None, {}),
            ("join-no-node", a, "POST", "/cluster/join", {}, {}),
            ("join-bad-addr", a, "POST", "/cluster/join",
             {"node": "not-an-address"}, {}),
            ("adopt-no-list", a, "POST", "/cluster/adopt", {"sids": 3}, {}),
            ("adopt-nothing", a, "POST", "/cluster/adopt",
             {"sids": ["s404-<a>"]}, {}),
            ("cluster-unknown-verb", a, "GET", "/cluster/nope", None, {}),
            ("gossip-stranger", a, "POST", "/cluster/gossip",
             {"node": "h9:1", "seq": 1}, {}),
            ("healthz-a", a, "GET", "/healthz", None, {}),
            ("usage-a", a, "GET", "/usage", None, {}),
            ("slo-unarmed", a, "GET", "/slo", None, {}),
            ("drain-a", a, "POST", "/cluster/drain", None, {}),
            ("healthz-a-draining", a, "GET", "/healthz", None, {}),
            ("step-y-after-drain", a, "POST", f"/sessions/{y}/step",
             {"steps": 4}, {}),
            ("frame-y-after-drain", b, "GET", f"/sessions/{y}/snapshot",
             None, {"Accept": GRID}),
            ("drain-a-again", a, "POST", "/cluster/drain", None, {}),
        ]
        for label, front, method, path, body, headers in script:
            if label == "usage-a":
                a.node.gossip_now()
            for real, mask in masks:
                path = path.replace(mask, real)
            out[label] = _send(front.addr, method, path, body, headers)
        # the owner dies: GETs retry then answer 503 + Retry-After, a
        # POST fails fast the same way, and its tickets answer 404s
        b.close()
        for label, method, path, body in [
                ("dead-owner-get", "GET", f"/sessions/{y}/snapshot", None),
                ("dead-owner-post", "POST", f"/sessions/{y}/step",
                 {"steps": 1}),
                ("dead-owner-ticket", "GET", f"/result/t1@{b.node.tag}",
                 None)]:
            out[label] = _send(a.addr, method, path, body)
        return out, masks
    finally:
        a.close()
        b.close()


def _mask(x, masks):
    if isinstance(x, dict):
        return {_mask(k, masks): _mask(v, masks) for k, v in x.items()}
    if isinstance(x, list):
        return [_mask(v, masks) for v in x]
    if isinstance(x, str):
        for real, mask in masks:
            x = x.replace(real, mask)
        return x
    return x


def _scrub(x, drop=()):
    if isinstance(x, dict):
        return {k: ("<measured>" if k in MEASURED | CLUSTER_MEASURED
                    # the ring lists its nodes sorted by real address
                    else sorted(v) if k == "ring"
                    else _scrub(v, drop))
                for k, v in x.items() if k not in drop}
    if isinstance(x, list):
        return [_scrub(v, drop) for v in x]
    if isinstance(x, str):
        return "cuda" if x == "tpu" else x.replace("/tpu/", "/cuda/")
    return x


@pytest.fixture(scope="module")
def pair_replies(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cluster_pairs"))
    # one roof on both sides (each platform's own default differs)
    os.environ["MPI_TPU_ROOF_OPS_PER_S"] = "1e12"
    try:
        return {side: _run_pair(side, root) for side in ("ref", "port")}
    finally:
        os.environ.pop("MPI_TPU_ROOF_OPS_PER_S", None)


PAIR_LABELS = [
    "cluster-info-a", "step-x-proxied", "step-x-owner", "frame-x-proxied",
    "frame-x-owner", "json-x-proxied", "density-x-proxied",
    "describe-x-proxied", "write-x-proxied", "step-x-after-write",
    "frame-x-after-write", "write-y-proxied", "step-y-proxied",
    "frame-y-proxied", "async-x", "result-x-by-tag", "result-x-frame",
    "unknown-ticket-peer", "unknown-ticket-stranger", "stream-x-redirect",
    "one-hop-guard", "unknown-session", "join-no-node", "join-bad-addr",
    "adopt-no-list", "adopt-nothing", "cluster-unknown-verb",
    "gossip-stranger", "healthz-a", "usage-a", "slo-unarmed", "drain-a",
    "healthz-a-draining", "step-y-after-drain", "frame-y-after-drain",
    "drain-a-again", "dead-owner-get", "dead-owner-post",
    "dead-owner-ticket",
]


@pytest.mark.parametrize("label", PAIR_LABELS)
def test_pair_reply_equals_the_references(pair_replies, label):
    (ref, ref_masks), (ours, our_masks) = (pair_replies["ref"],
                                           pair_replies["port"])
    r, o = ref[label], ours[label]
    # status, content type and Retry-After equal; Location masked
    assert o[:3] == r[:3], (label, o[:3], r[:3])
    assert _mask(o[3], our_masks) == _mask(r[3], ref_masks), label
    if r[1] == GRID:
        assert o[4] == r[4], label          # frames byte for byte
        return
    if not r[4]:
        assert not o[4], label
        return
    a = _mask(json.loads(o[4]), our_masks)
    b = _mask(json.loads(r[4]), ref_masks)
    assert _scrub(a, PORT_ONLY) == _scrub(b), label


def test_pair_script_answers_what_it_means(pair_replies):
    """The script really took each path the parity above compares."""
    ours, _ = pair_replies["port"]
    codes = {k: v[0] for k, v in ours.items()}
    for label in ("step-x-proxied", "frame-x-proxied", "result-x-by-tag",
                  "drain-a", "step-y-after-drain"):
        assert codes[label] == 200, label
    assert json.loads(ours["step-x-owner"][4])["generation"] == 16
    assert ours["frame-x-proxied"][4] == ours["frame-x-owner"][4]
    assert codes["stream-x-redirect"] == 307
    assert codes["one-hop-guard"] == 404
    assert codes["dead-owner-get"] == codes["dead-owner-post"] == 503
    assert int(ours["dead-owner-get"][2]) >= 1
    assert codes["dead-owner-ticket"] == 404
    drained = json.loads(ours["drain-a"][4])
    assert drained["ok"] and drained["handed_off"] == 1
    assert json.loads(ours["step-y-after-drain"][4])["generation"] == 19
    assert json.loads(ours["drain-a-again"][4])["handed_off"] == 0


# ------------------------------------------------ the cluster families


def test_cluster_families_are_the_references_extraction():
    assert FAMILIES["cluster"] == tuple(cluster_families())


@pytest.fixture(scope="module")
def cluster_scrapes(tmp_path_factory):
    out = {}
    for side in ("ref", "port"):
        state = str(tmp_path_factory.mktemp(f"scrape_{side}"))
        a, b = _Node(side, state), _Node(side, state)
        try:
            a.join([b.addr], state)
            b.join([a.addr], state)
            a.node.gossip_now()
            out[side] = _send(a.addr, "GET", "/metrics")[4].decode()
        finally:
            a.close()
            b.close()
    return out


def test_cluster_scrape_families_equal_the_references(cluster_scrapes):
    ours, ref = cluster_scrapes["port"], cluster_scrapes["ref"]
    for text in (ours, ref):
        names = {ln.split()[2] for ln in text.splitlines()
                 if ln.startswith("# TYPE ")}
        assert set(FAMILIES["cluster"]) <= names

    def cluster_only(text):
        helps, labels = _families(text)
        keep = tuple(FAMILIES["cluster"])
        return ([h for h in helps if h.split()[2].startswith(keep)],
                {(n, lb) for n, lb in labels if n.startswith(keep)})

    assert cluster_only(ours) == cluster_only(ref)
    _types, samples = parse_prometheus(ours)
    values = {(n, tuple(sorted(lb.items()))): v for n, lb, v in samples
              if n.startswith("mpi_tpu_cluster_")}
    assert values[("mpi_tpu_cluster_peers", (("state", "alive"),))] == 1
    assert values[("mpi_tpu_cluster_gossip_total",
                   (("direction", "sent"),))] == 1
