"""``mpi_tpu_torch.cluster`` — N serving processes as one logical service.

The port's copy of the reference's ``mpi_tpu/cluster`` (stdlib only,
like the reference's): it federates the single-process serve stack
across N processes, each stepping its sessions on its card, without
changing any single-process byte: with ``--peers`` unset nothing here
is imported on a request path.

* **sticky session routing** (``ring.py``) — consistent hashing on the
  session id plus a small persisted routing table; any front answers
  any request, proxying (``proxy.py``) one hop to the owner.
* **membership + gossip** (``gossip.py``, ``node.py``) — a stdlib
  push-pull digest protocol over the serving port carrying heartbeats,
  breaker open/close labels (one host's poisoned plan quarantines its
  siblings'), and usage-ledger totals.
* **cluster observability** — ``/usage`` and ``/healthz`` grow a
  ``cluster`` roll-up block; ``/metrics`` stays per-process with
  ``host``/``process`` constant labels for Prometheus-native
  federation.

See README "Cluster mode on the card" for the topology and flags.
"""

from mpi_tpu_torch.cluster.gossip import GOSSIP_PATH, Gossiper, send_digest
from mpi_tpu_torch.cluster.node import ClusterNode, node_tag
from mpi_tpu_torch.cluster.proxy import (
    FORWARDED_HEADER, SESSION_ID_HEADER, PeerUnreachable, proxy_request,
    split_addr,
)
from mpi_tpu_torch.cluster.ring import HashRing, RoutingTable

__all__ = [
    "ClusterNode", "Gossiper", "HashRing", "PeerUnreachable",
    "RoutingTable", "FORWARDED_HEADER", "GOSSIP_PATH", "SESSION_ID_HEADER",
    "node_tag", "proxy_request", "send_digest", "split_addr",
]
