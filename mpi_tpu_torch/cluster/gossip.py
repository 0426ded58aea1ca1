"""The gossip wire: push-pull digest exchange over the serving port.

Each node periodically POSTs its digest to every peer's
``/cluster/gossip`` endpoint (the ordinary serving front — no second
listener, no second port to firewall).  The receiver applies the digest
and answers with its *own* digest, which the sender applies in turn —
push-pull, so one side initiating a round synchronizes both directions
and a 2-node slice converges in a single interval even if only one
node's timer has fired yet.

Digests are tiny JSON: peer id, a per-sender sequence number (late or
duplicate deliveries are discarded by the receiver — idempotent by
construction), liveness facts, the sender's open-breaker label set, its
cumulative usage-ledger totals, and its local ``sid -> node`` routes.
"""

from __future__ import annotations

import json
import threading
from typing import Optional

from mpi_tpu_torch.cluster.proxy import (
    FORWARDED_HEADER, PeerUnreachable, proxy_request,
)

GOSSIP_PATH = "/cluster/gossip"
JOIN_PATH = "/cluster/join"
ADOPT_PATH = "/cluster/adopt"


def _post_json(addr: str, path: str, payload: dict, timeout_s: float,
               sender: str) -> dict:
    """POST one cluster-protocol message and parse the JSON reply.
    Raises :class:`~mpi_tpu_torch.cluster.proxy.PeerUnreachable` on transport
    failure and on a non-JSON or non-200 answer (a peer that cannot
    speak the protocol is as gone as one that cannot speak at all)."""
    body = json.dumps(payload).encode()
    status, _, data = proxy_request(
        addr, "POST", path, body,
        # protocol messages must never be re-routed by the receiving core
        headers={FORWARDED_HEADER: sender,
                 "Content-Type": "application/json",
                 "Content-Length": str(len(body))},
        timeout_s=timeout_s)
    if status != 200:
        raise PeerUnreachable(f"peer {addr} answered {status} to {path}")
    try:
        reply = json.loads(data)
    except ValueError as e:
        raise PeerUnreachable(f"peer {addr} sent non-JSON reply "
                              f"to {path}: {e}")
    if not isinstance(reply, dict):
        raise PeerUnreachable(f"peer {addr} sent malformed reply to {path}")
    return reply


def send_digest(addr: str, digest: dict, timeout_s: float = 5.0) -> dict:
    """POST ``digest`` to one peer; returns the peer's reply (its own
    digest rides in ``reply["digest"]``)."""
    return _post_json(addr, GOSSIP_PATH, digest, timeout_s,
                      digest.get("node", "?"))


def send_join(addr: str, node: str, timeout_s: float = 5.0) -> dict:
    """Announce ``node`` to an existing member (``POST /cluster/join``).
    The reply carries the member's digest, so one successful join
    teaches the joiner the whole membership in a single round."""
    return _post_json(addr, JOIN_PATH, {"node": node}, timeout_s, node)


def send_adopt(addr: str, node: str, sids: list,
               timeout_s: float = 5.0) -> dict:
    """Ask a ring successor to adopt ``sids`` from the shared state dir
    (the drain handoff: ``POST /cluster/adopt``)."""
    return _post_json(addr, ADOPT_PATH, {"sids": list(sids), "from": node},
                      timeout_s, node)


class Gossiper:
    """The background heartbeat thread: one round of
    ``node.gossip_now()`` every ``interval_s`` until stopped.  Daemon —
    a serving process exiting never waits on gossip."""

    def __init__(self, node, interval_s: float):
        self._node = node
        self.interval_s = max(0.05, float(interval_s))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="mpi_tpu-gossip")
        self._thread.start()

    def _loop(self) -> None:
        try:
            # announce ourselves before the first round (off the caller's
            # thread: startup must never block on a peer that is itself
            # still starting up)
            self._node.join_cluster()
        except Exception:  # noqa: BLE001 — join is best-effort
            pass
        while not self._stop.wait(self.interval_s):
            try:
                self._node.gossip_now()
            except Exception:  # noqa: BLE001 — heartbeats must outlive bugs
                pass

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None
