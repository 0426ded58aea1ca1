"""Consistent-hash ring + persisted routing table: who owns a session.

Session placement has two layers, consulted in order:

1. the :class:`RoutingTable` — explicit ``sid -> (node, epoch)``
   entries, recorded at create time and merged from peers' gossip
   digests.  The epoch is the cluster's membership clock (bumped on
   every join / confirmed death / drain): a failover adoption records
   the new owner at a *higher* epoch, so merge order cannot resurrect a
   route into a dead address.  With a ``--state-dir`` the table
   persists (tmp+fsync+replace, same crash-safety idiom as
   ``serve/recovery.py``), so a restarted front still knows where
   surviving sessions live even if its ring view changed;
2. the :class:`HashRing` — sha1 consistent hashing with virtual nodes,
   the stateless fallback that lets any front place a *new* session id
   identically without coordination.

Both are pure data structures (no sockets); ``cluster/node.py`` wires
them to the gossip protocol and rebuilds the ring on membership change.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
import sys
import threading
from typing import Dict, List, Optional, Tuple

# persisted format: {"v": 2, "routes": {sid: [node, epoch]}}.  A v1
# file (flat {sid: node}) loads with every entry at epoch 0.
TABLE_VERSION = 2


def _hash(key: str) -> int:
    return int.from_bytes(hashlib.sha1(key.encode()).digest()[:8], "big")


class HashRing:
    """Consistent hashing over a node set.  ``replicas`` virtual points
    per node smooth the distribution (with 2 nodes and 64 vnodes the
    split is within a few percent of even).  The instance is immutable;
    dynamic membership (``cluster/node.py``) swaps in a freshly built
    ring on every epoch bump — readers always see one coherent view."""

    def __init__(self, nodes: List[str], replicas: int = 64):
        if not nodes:
            raise ValueError("ring needs at least one node")
        self.nodes = sorted(set(nodes))
        self.replicas = int(replicas)
        points = []
        for node in self.nodes:
            for i in range(self.replicas):
                points.append((_hash(f"{node}#{i}"), node))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [n for _, n in points]

    def owner(self, key: str) -> str:
        """The node owning ``key`` — the first virtual point clockwise
        from the key's hash (wrapping)."""
        i = bisect.bisect_right(self._points, _hash(key))
        if i == len(self._points):
            i = 0
        return self._owners[i]


class RoutingTable:
    """Thread-safe ``sid -> (node, epoch)`` map with optional JSON
    persistence.

    Merge rule: a strictly newer epoch always wins (failover/drain
    re-homing); at equal epochs the last writer wins (the pre-epoch
    behavior — owners are fixed for a session's lifetime, so same-epoch
    disagreement only ever means a re-learned identical entry).  A
    missing file loads as empty; a corrupt one *also* loads as empty
    but is counted (``resets``, scraped as
    ``mpi_tpu_routing_table_resets_total``) and warned about — routing
    degrades to the ring, never blocks startup, but no longer silently.
    """

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._routes: Dict[str, Tuple[str, int]] = {}
        self.resets = 0                 # corrupt-file recoveries
        if path and os.path.exists(path):
            try:
                with open(path) as f:
                    data = json.load(f)
                self._routes = self._parse(data)
            except (OSError, ValueError):
                self.resets += 1
                print(f"[mpi_tpu] warning: routing table {path} is "
                      f"corrupt or unreadable; starting empty (placement "
                      f"degrades to the ring until routes are re-learned)",
                      file=sys.stderr)

    @staticmethod
    def _parse(data) -> Dict[str, Tuple[str, int]]:
        if not isinstance(data, dict):
            raise ValueError("routing table must be a JSON object")
        if data.get("v") == TABLE_VERSION:
            routes = data.get("routes")
            if not isinstance(routes, dict):
                raise ValueError("v2 routing table lacks a routes object")
            items = routes.items()
        else:
            items = data.items()        # v1: flat sid -> node, epoch 0
        out: Dict[str, Tuple[str, int]] = {}
        for sid, val in items:
            if isinstance(val, (list, tuple)) and len(val) == 2:
                out[str(sid)] = (str(val[0]), int(val[1]))
            else:
                out[str(sid)] = (str(val), 0)
        return out

    def get(self, sid: str) -> Optional[str]:
        with self._lock:
            entry = self._routes.get(sid)
            return entry[0] if entry is not None else None

    def entry(self, sid: str) -> Optional[Tuple[str, int]]:
        with self._lock:
            return self._routes.get(sid)

    def record(self, sid: str, node: str, epoch: int = 0) -> None:
        self.update({sid: (node, epoch)})

    def update(self, routes: Dict) -> None:
        """Merge ``routes`` in (gossip apply / local create / adoption)
        and persist when anything changed.  Values are ``(node, epoch)``
        pairs or bare node strings (epoch 0 — the pre-epoch digest
        shape, still accepted from old peers)."""
        if not routes:
            return
        with self._lock:
            changed = False
            for sid, val in routes.items():
                if isinstance(val, (list, tuple)):
                    node, epoch = str(val[0]), int(val[1])
                else:
                    node, epoch = str(val), 0
                cur = self._routes.get(str(sid))
                if cur is not None and epoch < cur[1]:
                    continue            # stale: an older membership epoch
                if cur != (node, epoch):
                    self._routes[str(sid)] = (node, epoch)
                    changed = True
            snapshot = dict(self._routes) if changed and self.path else None
        if snapshot is not None:
            self._save(snapshot)

    def _save(self, snapshot: Dict[str, Tuple[str, int]]) -> None:
        try:
            tmp = f"{self.path}.tmp"
            with open(tmp, "w") as f:
                json.dump({"v": TABLE_VERSION,
                           "routes": {sid: [node, epoch]
                                      for sid, (node, epoch)
                                      in snapshot.items()}}, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except OSError:
            pass                        # persistence is best-effort

    def snapshot(self) -> Dict[str, str]:
        """``sid -> node`` (the pre-epoch shape — placement callers
        only need the owner)."""
        with self._lock:
            return {sid: node for sid, (node, _) in self._routes.items()}

    def snapshot_entries(self) -> Dict[str, List]:
        """``sid -> [node, epoch]`` — the JSON-ready shape gossip
        digests carry."""
        with self._lock:
            return {sid: [node, epoch]
                    for sid, (node, epoch) in self._routes.items()}

    def __len__(self) -> int:
        with self._lock:
            return len(self._routes)
