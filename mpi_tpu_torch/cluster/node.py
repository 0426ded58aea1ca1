""":class:`ClusterNode` — one serving process's membership in the slice.

The node owns the cluster-local state the rest of the stack consults:

* identity — the advertised ``host:port`` is the node id; its 6-hex-char
  sha1 ``tag`` namespaces session ids (``s3-ab12cd``) and ticket ids
  (``t7@ab12cd``) so any front can read an id and know the owner without
  a lookup;
* membership — an epoch-versioned member map: every entry is
  ``addr -> (status, version)`` where the version is the epoch at which
  that fact was asserted.  Joins (``POST /cluster/join``), suspect →
  confirmed-dead transitions (missed heartbeats), and drains each bump
  the epoch; gossip carries the whole map and higher versions win (tie:
  dead wins), so views converge without coordination.  The consistent-
  hash ring is rebuilt from the *alive* members on every change;
* placement — :meth:`owner_addr` (routing table first, consistent-hash
  ring fallback) answers "which process serves this session".  Routes
  carry the epoch they were recorded at, so a failover adoption's route
  beats the dead owner's stale one in every merge order;
* failover — when a peer is confirmed dead, the new ring owner of each
  orphaned session restores it from the shared ``--state-dir`` via the
  deterministic replay path (``serve/recovery.py``) and re-records +
  gossips the route.  Tickets are process-local by contract: the dead
  node's tag is kept as a tombstone so its tickets keep answering the
  exact structured 404 (adoption never resurrects a ticket);
* drain — :meth:`drain` checkpoints every local session at its current
  generation, hands each to its ring successor (``POST
  /cluster/adopt``), and flips ``/healthz`` to draining.  The handoff
  is synchronous per successor: routes move only after the successor
  confirmed adoption, so no generation is ever lost;
* gossip — :meth:`digest`/:meth:`apply_digest` implement the push-pull
  exchange (``cluster/gossip.py`` drives it on a timer;
  :meth:`gossip_now` runs one synchronous round, which the tests use
  for determinism).  A digest carries
  heartbeat + session count, the epoch + member map, the sender's
  open-breaker labels, cumulative usage-ledger totals, and routes;
* roll-ups — :meth:`usage_rollup` (the ``cluster`` block on
  ``GET /usage``) sums the latest ledger snapshot from every node
  exactly; :meth:`health_block` (the ``cluster`` block on ``/healthz``)
  reports per-peer liveness from heartbeat age.

Everything here is stdlib.  Network faults from
``--inject-faults`` (sites ``gossip``/``proxy``) are injected through
:meth:`net_fault`, so membership convergence and failover are testable
under deterministic seeded partitions.
"""

from __future__ import annotations

import hashlib
import re
import sys
import threading
import time
from typing import Dict, List, Optional

from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.cluster.gossip import (
    Gossiper, send_adopt, send_digest, send_join,
)
from mpi_tpu_torch.cluster.proxy import PeerUnreachable, split_addr
from mpi_tpu_torch.cluster.ring import HashRing, RoutingTable
from mpi_tpu_torch.serve.faults import InjectedNetworkFault


def node_tag(addr: str) -> str:
    """The 6-hex-char tag a node stamps into the ids it allocates —
    deterministic from the advertised address, so every peer can map an
    id back to its owner without any protocol round."""
    return hashlib.sha1(addr.encode()).hexdigest()[:6]


class _PeerState:
    """What gossip has taught us about one live peer (guarded by the
    node lock)."""

    __slots__ = ("addr", "tag", "last_seen", "last_seq", "sessions",
                 "ledger", "slo", "tenants", "breakers_open", "added_at",
                 "inc", "suspect", "persist_degraded")

    def __init__(self, addr: str):
        self.addr = addr
        self.tag = node_tag(addr)
        self.last_seen: Optional[float] = None      # monotonic heartbeat
        self.last_seq = 0
        self.sessions = 0
        self.ledger: Optional[dict] = None          # latest totals() snapshot
        self.slo: Optional[dict] = None             # latest compact SLO state
        self.tenants: Optional[dict] = None         # latest tenant windows
        self.breakers_open: List[str] = []
        self.added_at = time.monotonic()            # suspect clock baseline
        self.inc: Optional[float] = None            # sender incarnation
        self.suspect = False
        # the peer's persistence-degraded bit: while True,
        # its recent checkpoints are known-unwritten, so failover must
        # not adopt its sessions from the shared state dir
        self.persist_degraded = False


class ClusterNode:
    """One process's view of the slice.  Constructed after the serving
    socket is bound (the advertise address must be real), attached via
    ``SessionManager.attach_cluster`` and ``AppCore.cluster``."""

    def __init__(self, advertise: str, peers: List[str], manager, *,
                 interval_s: float = 1.0, timeout_s: float = 5.0,
                 down_after_s: Optional[float] = None,
                 dead_after_s: Optional[float] = None,
                 proxy_retries: int = 2,
                 proxy_backoff_s: float = 0.05,
                 proxy_timeout_s: Optional[float] = None,
                 state_dir: Optional[str] = None, obs=None):
        split_addr(advertise)           # validate early: ValueError on junk
        self.id = advertise
        self.tag = node_tag(advertise)
        self.manager = manager
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        # proxy-hop hardening: idempotent verbs
        # retry with backoff; the hop timeout is its own knob
        if proxy_retries < 0:
            raise ConfigError(
                f"proxy retries must be >= 0, got {proxy_retries}")
        self.proxy_retries = int(proxy_retries)
        self.proxy_backoff_s = max(0.0, float(proxy_backoff_s))
        self.proxy_timeout_s = (float(proxy_timeout_s)
                                if proxy_timeout_s is not None
                                else self.timeout_s)
        # a peer is "down"/suspect when its heartbeat is older than
        # down_after_s (also the TTL on remote-open breaker quarantines);
        # it is CONFIRMED dead — removed from the ring, sessions adopted
        # — when the silence exceeds dead_after_s
        self.down_after_s = (float(down_after_s) if down_after_s is not None
                             else max(3.0 * self.interval_s, 1.5))
        self.dead_after_s = (float(dead_after_s) if dead_after_s is not None
                             else 3.0 * self.down_after_s)
        if self.dead_after_s < self.down_after_s:
            raise ConfigError(
                f"dead-after ({self.dead_after_s}s) must be >= down-after "
                f"({self.down_after_s}s)")
        self.peers: Dict[str, _PeerState] = {}
        for addr in peers:
            addr = addr.strip()
            if not addr or addr == advertise:
                continue                # tolerate self in the peer list
            split_addr(addr)
            self.peers.setdefault(addr, _PeerState(addr))
        tags = {self.tag: self.id}
        for ps in self.peers.values():
            other = tags.setdefault(ps.tag, ps.addr)
            if other != ps.addr:
                raise ConfigError(
                    f"peer tag collision: {other!r} and {ps.addr!r} both "
                    f"hash to {ps.tag!r}; change one address")
        # membership: addr -> [status, version]; the version is the
        # epoch at which the fact was asserted (higher wins, tie: dead
        # wins).  Dead entries persist as tombstones — they keep the
        # fact circulating and anchor the ticket-404 contract.
        self.epoch = 0
        self.members: Dict[str, List] = {self.id: ["alive", 0]}
        for addr in self.peers:
            self.members[addr] = ["alive", 0]
        self._dead: Dict[str, dict] = {}            # addr -> tombstone info
        self._dead_tags: Dict[str, str] = {}        # tag -> dead addr
        self.draining = False
        self.ring = HashRing([self.id] + list(self.peers))
        # the routing table is per-node even under a shared --state-dir
        # (the session records are shared for failover; each node's
        # learned view is its own)
        path = (f"{state_dir}/routing-{self.tag}.json" if state_dir
                else None)
        self.table = RoutingTable(path)
        self._lock = threading.Lock()
        self._adopt_lock = threading.Lock()
        self._no_adopt: set = set()     # sids with no record: don't re-try
        self._seq = 0
        self._inc = time.time()         # incarnation: resets peer seq gates
        self.gossip_sent = 0
        self.gossip_received = 0
        self.gossip_stale = 0           # duplicate/late digests discarded
        self.gossip_errors = 0
        self.membership_changes = {"join": 0, "rejoin": 0, "confirm_dead": 0}
        self.failover_adopted = 0
        self.failover_lost = 0
        self.drain_handed_off = 0
        self.drain_adopted = 0
        self._gossiper = Gossiper(self, interval_s)
        self._obs = obs
        self._sid_next = 1
        self.sync_local_sessions()
        if obs is not None:
            self._bind_metrics(obs)

    # -- identity & placement ----------------------------------------------

    def new_session_id(self) -> str:
        """The next session id this node may allocate — globally unique
        because the tag is, whichever front the create landed on."""
        with self._lock:
            n = self._sid_next
            self._sid_next += 1
        return f"s{n}-{self.tag}"

    def sync_local_sessions(self) -> None:
        """Re-announce the manager's local sessions to the routing
        table and resume the sid counter past them (boot restore and
        cluster-deferred restore both land here) — a restart with the
        same ``--state-dir`` cannot re-issue a live id."""
        sids = self.manager.session_ids()
        start = 1
        for sid in sids:
            m = re.match(r"s(\d+)", sid)
            if m:
                start = max(start, int(m.group(1)) + 1)
        with self._lock:
            self._sid_next = max(self._sid_next, start)
            epoch = self.epoch
        self.table.update({sid: (self.id, epoch) for sid in sids})

    def owner_addr(self, sid: str) -> str:
        """The node serving ``sid``: an explicit route when one is known
        (create-time record, gossip, or adoption), else the ring's
        stateless placement.  Routes naming nodes outside the live
        membership are ignored — a stale table must degrade to the
        ring, never proxy into a dead address."""
        route = self.table.get(sid)
        if route is not None and (route == self.id or route in self.peers):
            return route
        return self.ring.owner(sid)

    def ticket_owner_addr(self, tid: str) -> Optional[str]:
        """The live peer owning ticket ``tid``, or None when it is
        local (our tag, an unsuffixed pre-cluster id, or an unknown tag
        — the local lookup then answers the structured 404 the contract
        promises)."""
        _, sep, tag = tid.partition("@")
        if not sep or tag == self.tag:
            return None
        with self._lock:
            for ps in self.peers.values():
                if ps.tag == tag:
                    return ps.addr
        return None

    def dead_ticket_addr(self, tid: str) -> Optional[str]:
        """The confirmed-dead member a ticket's tag names, if any.
        Tickets are process-local and died with their process; the
        transport answers the exact structured 404 (``{"error",
        "peer"}``) without a doomed proxy attempt — failover adoption
        restores *sessions*, never tickets."""
        _, sep, tag = tid.partition("@")
        if not sep or tag == self.tag:
            return None
        with self._lock:
            return self._dead_tags.get(tag)

    def record_route(self, sid: str, node: Optional[str] = None) -> None:
        """Record ``sid``'s owner (default: this node).  The allocating
        front passes the peer it just placed a create on: a route known
        only to its owner is lost if the owner dies before its first
        gossip round, and failover can only adopt orphans somebody's
        table (or the sid's tag suffix) still names."""
        with self._lock:
            epoch = self.epoch
        self.table.update({sid: (node or self.id, epoch)})

    # -- fault injection (sites: gossip, proxy) ----------------------------

    def net_fault(self, site: str, peer: str) -> None:
        """The chaos seam: consult the manager's fault injector before
        an outbound network attempt.  An injected drop/partition
        surfaces as :class:`PeerUnreachable` — exactly what a real
        severed link raises, so every downstream path (gossip error
        counting, proxy retry, suspect/confirm) is the production
        one."""
        faults = getattr(self.manager, "faults", None)
        if faults is None:
            return
        try:
            faults.net_hook(site, peer)
        except InjectedNetworkFault as e:
            raise PeerUnreachable(str(e)) from e

    def inbound_cut(self, site: str) -> bool:
        faults = getattr(self.manager, "faults", None)
        return faults is not None and faults.inbound_cut(site)

    # -- membership --------------------------------------------------------

    def _rebuild_ring_locked(self) -> None:
        alive = [a for a, (st, _) in self.members.items() if st == "alive"]
        if self.id not in alive:
            alive.append(self.id)       # we are always our own member
        self.ring = HashRing(alive)

    def _admit_locked(self, addr: str, version: int) -> bool:
        """Create live peer state for ``addr`` (lock held).  False when
        the address cannot be admitted (tag collision — warned, not
        fatal: one junk joiner must not take the node down)."""
        tag = node_tag(addr)
        if tag == self.tag or any(ps.tag == tag
                                  for ps in self.peers.values()):
            print(f"[mpi_tpu] warning: cannot admit {addr!r}: tag "
                  f"{tag!r} collides with an existing member",
                  file=sys.stderr)
            return False
        self.peers[addr] = _PeerState(addr)
        self.members[addr] = ["alive", int(version)]
        self._dead_tags.pop(tag, None)
        self._dead.pop(addr, None)
        return True

    def handle_join(self, addr: str) -> dict:
        """``POST /cluster/join`` — admit a fresh process at any
        advertise address.  Idempotent: a known member re-joining is
        re-asserted alive at a fresh epoch (so a racing death tombstone
        elsewhere loses the merge).  The reply carries our digest —
        one successful join teaches the joiner the whole membership."""
        addr = str(addr).strip()
        split_addr(addr)                # ValueError -> structured 400
        kind = None
        if addr != self.id:
            with self._lock:
                self.epoch += 1
                was_dead = addr in self._dead
                if addr in self.peers:
                    self.members[addr] = ["alive", self.epoch]
                    kind = "rejoin"
                elif self._admit_locked(addr, self.epoch):
                    self._rebuild_ring_locked()
                    kind = "rejoin" if was_dead else "join"
                epoch = self.epoch
            if kind is not None:
                self.membership_changes[kind] += 1
                self.event("membership_change", kind=kind, member=addr,
                            epoch=epoch)
        return {"ok": True, "node": self.id, "epoch": self.epoch,
                "members": self._members_copy(), "digest": self.digest()}

    def join_cluster(self) -> int:
        """Announce ourselves to every seed peer (best-effort; returns
        how many answered).  This is what lets a *replacement* process
        enter at a fresh address: its seeds may not list it in their
        own ``--peers``, and plain gossip from an unknown sender is
        dropped — the explicit join is the admission path."""
        joined = 0
        for addr in list(self.peers):
            try:
                reply = send_join(addr, self.id, timeout_s=self.timeout_s)
            except PeerUnreachable:
                continue
            joined += 1
            their = reply.get("digest")
            if isinstance(their, dict):
                self.apply_digest(their)
        return joined

    def check_membership(self) -> List[str]:
        """Advance the suspect → confirmed-dead state machine from
        heartbeat ages (driven by every gossip round; tests call it
        directly).  Returns the addresses confirmed dead this pass —
        each is removed from membership and the ring at a bumped epoch,
        and its orphaned sessions go through failover adoption."""
        now = time.monotonic()
        confirmed = []
        with self._lock:
            for addr, ps in self.peers.items():
                ref = ps.last_seen if ps.last_seen is not None else ps.added_at
                age = now - ref
                if age > self.dead_after_s:
                    confirmed.append(addr)
                else:
                    ps.suspect = age > self.down_after_s
        for addr in confirmed:
            self._confirm_dead(addr)
        return confirmed

    def _confirm_dead(self, addr: str) -> None:
        with self._lock:
            ps = self.peers.pop(addr, None)
            if ps is None:
                return                  # raced with another confirmation
            self.epoch += 1
            epoch = self.epoch
            self.members[addr] = ["dead", epoch]
            self._dead_tags[ps.tag] = addr
            self._dead[addr] = {
                "tag": ps.tag,
                "last_seen": (ps.last_seen if ps.last_seen is not None
                              else ps.added_at),
                "sessions": ps.sessions,
                "persist_degraded": ps.persist_degraded,
            }
            self._rebuild_ring_locked()
            self.membership_changes["confirm_dead"] += 1
        adopted, lost = self._failover(addr, ps.tag, epoch,
                                       degraded=ps.persist_degraded)
        self.event("membership_change", kind="confirm_dead", member=addr,
                    epoch=epoch, adopted=adopted, lost=lost)

    def _failover(self, addr: str, tag: str, epoch: int,
                  degraded: bool = False):
        """Adopt the dead node's orphaned sessions that the post-death
        ring assigns to THIS node, from the shared state dir, via the
        deterministic replay path.  Routes re-record at the death epoch
        so they beat the dead owner's stale entries in every merge.
        ``degraded``: the dead peer's last gossiped persistence bit —
        True means its recent checkpoints are known-unwritten, so
        adopting its records would silently resurrect stale boards;
        the sessions are counted lost instead (a loud, honest outcome
        the operator can act on: scrub → repair → adopt)."""
        mgr = self.manager
        store = getattr(mgr, "store", None)
        adopted = lost = 0
        candidates = {sid for sid, node in self.table.snapshot().items()
                      if node == addr}
        if degraded:
            n = len(candidates)
            if store is not None:
                suffix = f"-{tag}"
                n = len(candidates | {sid for sid in store.list_ids()
                                      if sid.endswith(suffix)})
            if n:
                print(f"warning: not adopting {n} session(s) from dead "
                      f"peer {addr}: its persistence was degraded "
                      f"(checkpoints known-unwritten); run python -m "
                      f"mpi_tpu_torch.serve.scrub on the state dir, "
                      f"then POST /cluster/adopt",
                      file=sys.stderr)
            with self._lock:
                self.failover_lost += n
            return 0, n
        if store is not None:
            # records the dead node persisted but whose routes never
            # reached us: the sid carries the ALLOCATING front's tag, so
            # this over-approximates (a session allocated at the dead
            # front may have been placed elsewhere) — the held-set and
            # ring gates below discard the false positives
            suffix = f"-{tag}"
            candidates.update(sid for sid in store.list_ids()
                              if sid.endswith(suffix))
        held = set(mgr.session_ids())
        for sid in sorted(candidates):
            if sid in held:
                continue                # already (still) served here
            if self.ring.owner(sid) != self.id:
                continue                # the new owner adopts, not us
            with self._adopt_lock:
                ok = mgr.adopt_session(sid)
            if ok:
                adopted += 1
                self.table.update({sid: (self.id, epoch)})
            else:
                lost += 1
        with self._lock:
            self.failover_adopted += adopted
            self.failover_lost += lost
        return adopted, lost

    def handle_adopt(self, sids: List[str]) -> dict:
        """``POST /cluster/adopt`` — a draining peer hands us sessions
        it has just checkpointed.  Restore each from the shared state
        dir and claim the route at a fresh epoch."""
        with self._lock:
            self.epoch += 1
            epoch = self.epoch
        adopted, failed = [], []
        for sid in sids:
            sid = str(sid)
            self._no_adopt.discard(sid)
            with self._adopt_lock:
                ok = self.manager.adopt_session(sid)
            if ok:
                self.table.update({sid: (self.id, epoch)})
                adopted.append(sid)
            else:
                failed.append(sid)
        with self._lock:
            self.drain_adopted += len(adopted)
        return {"ok": not failed, "node": self.id, "epoch": epoch,
                "adopted": adopted, "failed": failed}

    def drain(self) -> dict:
        """``POST /cluster/drain`` — migrate every local session to its
        ring successor and flip ``/healthz`` to draining.  Per
        successor: checkpoint each session at its CURRENT generation
        (full grid snapshot — the adopter replays zero generations),
        ask the successor to adopt, and only then move the routes and
        release the local copies.  A successor that cannot adopt leaves
        its batch local and still served — zero lost generations either
        way."""
        with self._lock:
            others = [n for n in self.ring.nodes if n != self.id]
            if not others:
                raise ConfigError("cannot drain the only cluster member")
            self.draining = True
            self.epoch += 1
            epoch = self.epoch
        succ_ring = HashRing(others)
        handoffs: Dict[str, List[str]] = {}
        for sid in self.manager.session_ids():
            handoffs.setdefault(succ_ring.owner(sid), []).append(sid)
        moved: Dict[str, List[str]] = {}
        errors: Dict[str, str] = {}
        for succ, batch in sorted(handoffs.items()):
            try:
                for sid in batch:
                    self.manager.checkpoint_now(sid)
                self.net_fault("proxy", succ)
                reply = send_adopt(succ, self.id, batch,
                                   timeout_s=self.proxy_timeout_s)
            except (PeerUnreachable, KeyError, OSError) as e:
                # OSError covers the drain checkpoint failing to land
                # (injected io fault, degraded store): the batch stays
                # local and served — handing it off would lose every
                # generation since the last durable record
                errors[succ] = str(e)
                continue
            accepted = [sid for sid in reply.get("adopted") or []
                        if sid in batch]
            if accepted:
                self.table.update({sid: (succ, epoch) for sid in accepted})
                for sid in accepted:
                    try:
                        self.manager.release(sid)
                    except KeyError:
                        pass
                moved[succ] = accepted
        n_moved = sum(len(v) for v in moved.values())
        with self._lock:
            self.drain_handed_off += n_moved
        self.event("membership_change", kind="drain", member=self.id,
                    epoch=epoch, handed_off=n_moved)
        self.gossip_now()               # push the moved routes out now
        return {"ok": not errors, "node": self.id, "draining": True,
                "epoch": epoch, "handed_off": n_moved, "handoffs": moved,
                "errors": errors}

    # -- gossip ------------------------------------------------------------

    def digest(self) -> dict:
        """This node's current digest.  Breaker labels are the LOCAL
        open set only — remote-open quarantines learned from gossip are
        never re-announced, so a label can circulate only while its
        origin still asserts it (no echo keeping a closed breaker
        alive).  Membership rides as the full epoch-versioned map;
        routes as the full table with their epochs."""
        mgr = self.manager
        with self._lock:
            self._seq += 1
            seq = self._seq
            epoch = self.epoch
        sids = mgr.session_ids()
        missing = [sid for sid in sids if self.table.get(sid) is None]
        if missing:
            self.table.update({sid: (self.id, epoch) for sid in missing})
        return {
            "node": self.id,
            "seq": seq,
            "inc": self._inc,
            "epoch": epoch,
            "members": self._members_copy(),
            "sessions": len(sids),
            "breakers_open": mgr.cache.breaker_stats()["open"],
            "ledger": (mgr.obs.ledger.totals()
                       if mgr.obs is not None else None),
            # armed-only: unarmed nodes gossip None and the
            # /slo roll-up counts them as not reporting
            "slo": (mgr.obs.slo.compact()
                    if mgr.obs is not None and mgr.obs.slo is not None
                    else None),
            # armed-only: per-tenant window-spend snapshots
            # (absolute, merge_totals discipline — latest per node) so
            # quotas gate against cluster-wide spend, not node slices
            "tenants": (mgr.admission.window_snapshot()
                        if getattr(mgr, "admission", None) is not None
                        else None),
            # the degraded bit: True while this node's state
            # dir is refusing writes — peers must not failover-adopt
            # from records we may not have written
            "persist_degraded": bool(
                getattr(mgr, "store", None) is not None
                and mgr.store.is_degraded()),
            "routes": self.table.snapshot_entries(),
        }

    def _members_copy(self) -> Dict[str, List]:
        with self._lock:
            return {addr: list(entry)
                    for addr, entry in self.members.items()}

    def apply_digest(self, digest: dict) -> bool:
        """Fold one received digest in; returns True when it advanced
        state.  Any delivery refreshes the sender's heartbeat, but only
        a sequence number beyond the last seen applies — duplicates and
        stragglers are idempotent no-ops on every roll-up.  A digest
        from a tombstoned member is an implicit rejoin (it is evidently
        alive); one from a complete stranger is dropped — admission is
        ``/cluster/join``'s job."""
        addr = digest.get("node")
        seq = digest.get("seq")
        if not isinstance(seq, int):
            return False
        ps = self.peers.get(addr)
        if ps is None:
            if addr in self._dead:
                self._readmit(addr)
                ps = self.peers.get(addr)
            if ps is None:
                return False            # unknown sender or junk: drop
        with self._lock:
            ps.last_seen = time.monotonic()
            ps.suspect = False
            inc = digest.get("inc")
            if (isinstance(inc, (int, float)) and ps.inc is not None
                    and inc != ps.inc):
                ps.last_seq = 0         # restarted peer: fresh seq space
            if isinstance(inc, (int, float)):
                ps.inc = inc
            if seq <= ps.last_seq:
                self.gossip_stale += 1
                return False
            ps.last_seq = seq
            ps.sessions = int(digest.get("sessions") or 0)
            ledger = digest.get("ledger")
            ps.ledger = ledger if isinstance(ledger, dict) else None
            slo = digest.get("slo")
            ps.slo = slo if isinstance(slo, dict) else None
            tenants = digest.get("tenants")
            ps.tenants = tenants if isinstance(tenants, dict) else None
            ps.breakers_open = [str(b) for b in
                                (digest.get("breakers_open") or [])]
            ps.persist_degraded = bool(digest.get("persist_degraded"))
            breakers = list(ps.breakers_open)
            self.gossip_received += 1
        self.manager.cache.set_remote_open(addr, breakers,
                                           ttl_s=self.down_after_s)
        self._merge_members(digest)
        routes = digest.get("routes")
        if isinstance(routes, dict):
            self.table.update(routes)
            self._adopt_routed_here(routes)
        return True

    def _merge_members(self, digest: dict) -> None:
        """Fold the sender's member map in: higher versions win, ties
        go to dead (a death is asserted, liveness only observed).  A
        tombstone naming US at a version we have not outbid is a wrong
        obituary — re-assert alive at a fresh epoch so the correction
        out-versions it everywhere."""
        members = digest.get("members")
        if not isinstance(members, dict):
            return
        newly_dead = []
        changed_ring = False
        with self._lock:
            for maddr, entry in members.items():
                if (not isinstance(entry, (list, tuple)) or len(entry) != 2):
                    continue
                st, ver = str(entry[0]), entry[1]
                if not isinstance(ver, int) or st not in ("alive", "dead"):
                    continue
                if maddr == self.id:
                    mine = self.members[self.id]
                    if st == "dead" and ver >= mine[1]:
                        self.epoch = max(self.epoch, ver) + 1
                        self.members[self.id] = ["alive", self.epoch]
                        changed_ring = True     # ring itself is fine, but
                        # peers rebuilt theirs without us; re-announcing at
                        # a higher version re-admits us on their side
                    continue
                cur = self.members.get(maddr)
                if cur is not None and (ver < cur[1] or
                                        (ver == cur[1]
                                         and (st == cur[0]
                                              or cur[0] == "dead"))):
                    continue            # stale, identical, or losing tie
                if st == "alive":
                    if maddr in self.peers:
                        self.members[maddr] = ["alive", ver]
                    elif self._admit_locked(maddr, ver):
                        changed_ring = True
                else:
                    self.members[maddr] = ["dead", ver]
                    dead_ps = self.peers.pop(maddr, None)
                    if dead_ps is not None:
                        self._dead_tags[dead_ps.tag] = maddr
                        self._dead[maddr] = {
                            "tag": dead_ps.tag,
                            "last_seen": (dead_ps.last_seen
                                          if dead_ps.last_seen is not None
                                          else dead_ps.added_at),
                            "sessions": dead_ps.sessions,
                        }
                        newly_dead.append((maddr, dead_ps.tag))
                        changed_ring = True
            self.epoch = max(self.epoch,
                             digest.get("epoch") if isinstance(
                                 digest.get("epoch"), int) else 0)
            if changed_ring:
                self._rebuild_ring_locked()
        for maddr, tag in newly_dead:
            with self._lock:
                self.membership_changes["confirm_dead"] += 1
                epoch = self.epoch
            adopted, lost = self._failover(maddr, tag, epoch)
            self.event("membership_change", kind="confirm_dead",
                        member=maddr, epoch=epoch, adopted=adopted,
                        lost=lost, learned=True)

    def _readmit(self, addr: str) -> None:
        """A tombstoned member contacted us — it is evidently alive.
        Re-admit it at a fresh epoch (the implicit-rejoin half of
        partition healing; the explicit half is ``/cluster/join``)."""
        with self._lock:
            if addr in self.peers or addr not in self._dead:
                return
            self.epoch += 1
            if not self._admit_locked(addr, self.epoch):
                return
            self._rebuild_ring_locked()
            epoch = self.epoch
            self.membership_changes["rejoin"] += 1
        self.event("membership_change", kind="rejoin", member=addr,
                    epoch=epoch)

    def _adopt_routed_here(self, routes: dict) -> None:
        """The gossip backup for drain handoff: a route naming US for a
        session we do not hold means a peer moved it here (its direct
        /cluster/adopt may have raced or failed).  Adopt from the
        shared state dir; a sid with no record is remembered and never
        re-tried (e.g. a closed session whose route still circulates)."""
        mgr = self.manager
        if getattr(mgr, "store", None) is None:
            return
        held = set(mgr.session_ids())
        for sid, val in routes.items():
            node = val[0] if isinstance(val, (list, tuple)) else val
            if node != self.id or sid in held or sid in self._no_adopt:
                continue
            with self._adopt_lock:
                ok = mgr.adopt_session(sid)
            if ok:
                with self._lock:
                    self.drain_adopted += 1
            else:
                self._no_adopt.add(sid)

    def gossip_now(self) -> None:
        """One synchronous push-pull round with every live peer,
        followed by one membership check (the timer thread's body; also
        the deterministic hook the tests drive).  The chaos harness
        taps the send path through :meth:`net_fault` — an injected
        drop counts as a gossip error exactly like a severed link."""
        digest = self.digest()
        for addr in list(self.peers):
            try:
                self.net_fault("gossip", addr)
                reply = send_digest(addr, digest, timeout_s=self.timeout_s)
            except PeerUnreachable:
                with self._lock:
                    self.gossip_errors += 1
                continue
            with self._lock:
                self.gossip_sent += 1
            their = reply.get("digest")
            if isinstance(their, dict):
                self.apply_digest(their)
        self.check_membership()

    def start(self) -> None:
        # the join runs on the gossip thread (Gossiper fires it before
        # its first round): two processes booting together must not
        # block each other's startup on a synchronous mutual join —
        # neither is accepting yet, and the stall would push the first
        # heartbeat past dead_after_s and flap the membership
        self._gossiper.start()

    def stop(self) -> None:
        self._gossiper.stop()

    # -- roll-ups ----------------------------------------------------------

    def tenant_spend(self, tenant: str):
        """Peer spend for one tenant: ``(device_s, cells, sessions)``
        summed over each peer's latest gossiped window snapshot (the
        QuotaGate adds the local books itself).  Same exactness contract
        as ``usage_rollup``: absolute snapshots, latest per node, at
        most one gossip interval stale."""
        device_s, cells, sessions = 0.0, 0, 0
        with self._lock:
            snaps = [ps.tenants for ps in self.peers.values()
                     if ps.tenants is not None]
        for snap in snaps:
            row = snap.get(tenant)
            if not isinstance(row, dict):
                continue
            try:
                device_s += float(row.get("device_s") or 0.0)
                cells += int(row.get("cells") or 0)
                sessions += int(row.get("sessions") or 0)
            except (TypeError, ValueError):
                continue                # junk from a peer never rejects
        return device_s, cells, sessions

    def usage_rollup(self) -> dict:
        """The ``cluster`` block on ``GET /usage``: exact sums over the
        local ledger plus each peer's latest gossiped totals (cumulative
        snapshots, not deltas — replacement is idempotent, so the sum is
        exact as of each peer's last digest, at most one interval
        stale)."""
        from mpi_tpu_torch.obs.ledger import merge_totals

        mgr = self.manager
        local = mgr.obs.ledger.totals() if mgr.obs is not None else None
        by_node: Dict[str, Optional[dict]] = {self.id: local}
        with self._lock:
            for addr, ps in self.peers.items():
                by_node[addr] = ps.ledger
        reporting = [t for t in by_node.values() if t]
        return {
            "node": self.id,
            "nodes": len(by_node),
            "nodes_reporting": len(reporting),
            "totals": merge_totals(reporting),
            "by_node": by_node,
        }

    def slo_rollup(self) -> dict:
        """The ``cluster`` block on ``GET /slo``: the local compact SLO
        state plus each peer's latest gossiped one.  Transition counts
        are CUMULATIVE per node, so summing the snapshots is exact as of
        each peer's last digest (the ledger roll-up discipline); a peer
        whose heartbeat says it is down lands in ``partial`` like the
        trace fan-out's — its stale snapshot stays visible in
        ``by_node`` but the roll-up admits it is incomplete."""
        _rank = {"ok": 0, "warning": 1, "critical": 2}
        mgr = self.manager
        local = (mgr.obs.slo.compact()
                 if mgr.obs is not None and mgr.obs.slo is not None
                 else None)
        by_node: Dict[str, Optional[dict]] = {self.id: local}
        with self._lock:
            for addr, ps in self.peers.items():
                by_node[addr] = ps.slo
        partial = sorted(addr for addr, st in
                         self.health_block()["peers"].items()
                         if not st["alive"])
        reporting = [s for s in by_node.values() if s]
        states = [s.get("worst") for s in reporting]
        states = [s for s in states if s in _rank]
        burning: Dict[str, str] = {}
        for snap in reporting:
            for name, state in (snap.get("states") or {}).items():
                if state in _rank and state != "ok" and \
                        _rank[state] > _rank.get(burning.get(name), -1):
                    burning[name] = state
        return {
            "node": self.id,
            "nodes": len(by_node),
            "nodes_reporting": len(reporting),
            "partial": partial,
            "complete": not partial,
            "worst": (max(states, key=_rank.__getitem__)
                      if states else "ok"),
            "burning": burning,
            "transitions_total": sum(
                int(s.get("transitions") or 0) for s in reporting),
            "by_node": by_node,
        }

    def health_block(self) -> dict:
        """The ``cluster`` block on ``/healthz``: per-peer liveness from
        heartbeat age, with the membership state machine spelled out
        (``alive``/``suspect``/``dead``).  Confirmed-dead members stay
        listed (alive: False) so operators and the trace fan-out see
        them; they are out of the ring regardless.  A down peer never
        flips the node's own ``ok`` — this process can still serve
        everything it owns."""
        now = time.monotonic()
        peers = {}
        with self._lock:
            for addr, ps in self.peers.items():
                ref = (ps.last_seen if ps.last_seen is not None
                       else ps.added_at)
                age = None if ps.last_seen is None else now - ps.last_seen
                alive = age is not None and age <= self.down_after_s
                peers[addr] = {
                    "alive": alive,
                    "state": ("alive" if alive else
                              "suspect" if now - ref > self.down_after_s
                              else "down"),
                    "last_seen_age_s": (None if age is None
                                        else round(age, 3)),
                    "sessions": ps.sessions,
                    "breakers_open": list(ps.breakers_open),
                }
            for addr, info in self._dead.items():
                peers[addr] = {
                    "alive": False,
                    "state": "dead",
                    "last_seen_age_s": round(now - info["last_seen"], 3),
                    "sessions": info["sessions"],
                    "breakers_open": [],
                }
            epoch, draining = self.epoch, self.draining
        return {"node": self.id, "tag": self.tag,
                "size": 1 + len([a for a in peers
                                 if peers[a]["state"] != "dead"]),
                "epoch": epoch, "draining": draining,
                "peers": peers}

    def info(self) -> dict:
        """``GET /cluster`` — the operator's one-stop membership view."""
        with self._lock:
            gossip = {
                "interval_s": self.interval_s,
                "sent": self.gossip_sent,
                "received": self.gossip_received,
                "stale": self.gossip_stale,
                "errors": self.gossip_errors,
            }
            members = {addr: list(entry)
                       for addr, entry in self.members.items()}
            failover = {
                "adopted": self.failover_adopted,
                "lost": self.failover_lost,
                "drain_handed_off": self.drain_handed_off,
                "drain_adopted": self.drain_adopted,
                "membership_changes": dict(self.membership_changes),
            }
        out = self.health_block()
        out["ring"] = self.ring.nodes
        out["members"] = members
        out["routes"] = len(self.table)
        out["gossip"] = gossip
        out["failover"] = failover
        return out

    # -- observability -----------------------------------------------------

    def event(self, name: str, **fields) -> None:
        """Emit one membership trace event (no-op without obs).  The
        call sites pass the kind literal directly so the obs-drift
        extraction sees every emitted name."""
        if self._obs is not None:
            self._obs.event(name, 0.0, time.time(), node=self.id, **fields)

    def _bind_metrics(self, obs) -> None:
        """Cluster metric families (scrape-time callbacks, same
        no-shadow-counting rule as ``Obs.bind_manager``).  Registered
        only in cluster mode — single-process scrapes keep their exact
        pre-cluster family set."""
        m = obs.metrics

        def _peer_liveness():
            peers = self.health_block()["peers"]
            alive = sum(1 for p in peers.values() if p["alive"])
            return [({"state": "alive"}, alive),
                    ({"state": "down"}, len(peers) - alive)]

        m.gauge_fn("mpi_tpu_cluster_peers",
                   "Cluster peers by gossip liveness state",
                   _peer_liveness)

        def _gossip_counts():
            with self._lock:
                return [({"direction": "sent"}, self.gossip_sent),
                        ({"direction": "received"}, self.gossip_received),
                        ({"direction": "stale"}, self.gossip_stale),
                        ({"direction": "error"}, self.gossip_errors)]

        m.counter_fn("mpi_tpu_cluster_gossip_total",
                     "Gossip digests exchanged, by direction/outcome",
                     _gossip_counts)

        def _epoch():
            with self._lock:
                return [({}, self.epoch)]

        m.gauge_fn("mpi_tpu_cluster_epoch",
                   "Membership epoch (bumps on join/confirm-dead/drain)",
                   _epoch)

        def _membership_changes():
            with self._lock:
                return [({"kind": k}, v)
                        for k, v in sorted(self.membership_changes.items())]

        m.counter_fn("mpi_tpu_cluster_membership_changes_total",
                     "Membership transitions applied, by kind",
                     _membership_changes)

        def _failover_sessions():
            with self._lock:
                return [({"outcome": "adopted"}, self.failover_adopted),
                        ({"outcome": "lost"}, self.failover_lost)]

        m.counter_fn("mpi_tpu_cluster_failover_sessions_total",
                     "Dead peers' sessions adopted from the shared "
                     "state dir (or lost: no record found)",
                     _failover_sessions)

        def _drain_sessions():
            with self._lock:
                return [({"direction": "handed_off"}, self.drain_handed_off),
                        ({"direction": "adopted"}, self.drain_adopted)]

        m.counter_fn("mpi_tpu_cluster_drain_sessions_total",
                     "Sessions migrated by drain, by direction",
                     _drain_sessions)

        def _table_resets():
            return [({}, self.table.resets)]

        m.counter_fn("mpi_tpu_routing_table_resets_total",
                     "Corrupt routing-table files discarded at load "
                     "(placement degraded to the ring)",
                     _table_resets)
