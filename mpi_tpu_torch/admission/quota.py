"""Sliding-window quota accounting in ledger currency.

The ``QuotaGate`` answers one question — *may this tenant spend an
estimated (device-seconds, cells) right now?* — against what the tenant
actually settled over its sliding window.  CostCards provide the
pre-dispatch estimate; the ``UsageLedger`` settlement hook provides the
charge (so the window holds real spend, not guesses).  Rejections carry
a Retry-After computed from the window itself: the instant at which
enough settled charges age out for the estimate to fit.

Cluster mode: each node gossips its local window snapshot (exact sums,
the ``merge_totals`` discipline — latest snapshot per node, never
deltas), and ``admit`` charges the estimate against *cluster-wide*
spend by adding a remote-spend callable the cluster node installs.

Thread-safety: one lock around the books.  ``charge`` runs on dispatch
threads (via the ledger hook), ``admit`` on request threads, and
``window_snapshot`` on the gossip thread.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Tuple


class AdmissionReject(RuntimeError):
    """Base for every admission-control rejection; maps to HTTP 429
    with a Retry-After header sized by ``retry_after_s``."""

    def __init__(self, msg: str, *, tenant: str, retry_after_s: float):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = float(retry_after_s)


class QuotaExceeded(AdmissionReject):
    """Tenant is over a window quota or its concurrent-session cap."""


def retry_after_header(retry_after_s: float) -> Tuple[str, str]:
    """The Retry-After header every backpressure rejection carries:
    integral seconds, never below 1."""
    return ("Retry-After", str(max(1, math.ceil(retry_after_s))))


class QuotaGate:
    """Per-tenant sliding-window spend books plus live-session counts."""

    def __init__(self, registry, clock: Callable[[], float] = time.monotonic):
        self.registry = registry
        self.clock = clock
        self._lock = threading.Lock()
        # tenant -> deque of (t, device_s, cells) settled charges, plus
        # running window totals so ``spent`` (the per-request hot path)
        # is O(1) — the deque is only walked on rejection (Retry-After)
        self._events: Dict[str, deque] = {}
        self._totals: Dict[str, list] = {}      # tenant -> [device_s, cells]
        # sid -> tenant, for session caps and settlement attribution
        self._sid_tenant: Dict[str, str] = {}
        # cluster hook: tenant -> (device_s, cells, sessions) across
        # peers; None in a single process
        self.remote_spend: Optional[Callable[[str], Tuple[float, int, int]]] \
            = None

    # -- attribution -------------------------------------------------

    def note_session(self, sid: str, tenant: str) -> None:
        with self._lock:
            self._sid_tenant[sid] = tenant

    def drop_session(self, sid: str) -> None:
        with self._lock:
            self._sid_tenant.pop(sid, None)

    def tenant_of(self, sid: str) -> Optional[str]:
        with self._lock:
            return self._sid_tenant.get(sid)

    # -- settlement --------------------------------------------------

    def charge(self, tenant: str, device_s: float, cells: int,
               now: Optional[float] = None) -> None:
        """Record a settled charge (from the ledger hook, post-dispatch)."""
        now = self.clock() if now is None else now
        with self._lock:
            q = self._events.setdefault(tenant, deque())
            q.append((now, float(device_s), int(cells)))
            tot = self._totals.setdefault(tenant, [0.0, 0])
            tot[0] += float(device_s)
            tot[1] += int(cells)
            self._prune(tenant, now)

    def _prune(self, tenant: str, now: float) -> None:
        window_s = self.registry.get(tenant)["window_s"]
        q = self._events.get(tenant)
        tot = self._totals.get(tenant)
        while q and q[0][0] <= now - window_s:
            _, d, c = q.popleft()
            tot[0] -= d
            tot[1] -= c
        if q is not None and not q and tot is not None:
            # empty window: snap the running floats back to exact zero
            # so decrement drift can never accumulate across windows
            tot[0], tot[1] = 0.0, 0

    def spent(self, tenant: str, now: Optional[float] = None) \
            -> Tuple[float, int]:
        """This node's settled (device_s, cells) inside the window."""
        now = self.clock() if now is None else now
        with self._lock:
            self._prune(tenant, now)
            tot = self._totals.get(tenant)
            return (0.0, 0) if tot is None else (tot[0], tot[1])

    def sessions_of(self, tenant: str) -> int:
        with self._lock:
            return sum(1 for t in self._sid_tenant.values() if t == tenant)

    # -- admission ---------------------------------------------------

    def admit(self, tenant: str, est_device_s: float, est_cells: int,
              now: Optional[float] = None) -> None:
        """Raise ``QuotaExceeded`` when the estimate does not fit the
        tenant's remaining window budget (cluster-wide when gossiping).
        Admission happens at enqueue, never after device work."""
        spec = self.registry.get(tenant)
        limit_s = spec["device_s_per_window"]
        limit_cells = spec["cells_per_window"]
        if limit_s is None and limit_cells is None:
            return
        now = self.clock() if now is None else now
        device_s, cells = self.spent(tenant, now)
        rem_device_s, rem_cells, _ = self._remote(tenant)
        device_s += rem_device_s
        cells += rem_cells
        if limit_s is not None and device_s + est_device_s > limit_s:
            raise QuotaExceeded(
                f"tenant {tenant!r} over device-seconds quota "
                f"({device_s:.3f}s spent + {est_device_s:.3f}s estimated "
                f"> {limit_s:.3f}s per {spec['window_s']:.0f}s window)",
                tenant=tenant,
                retry_after_s=self._retry_after(
                    tenant, now, need_device_s=device_s + est_device_s
                    - limit_s))
        if limit_cells is not None and cells + est_cells > limit_cells:
            raise QuotaExceeded(
                f"tenant {tenant!r} over cells quota "
                f"({cells} spent + {est_cells} estimated > {limit_cells} "
                f"per {spec['window_s']:.0f}s window)",
                tenant=tenant,
                retry_after_s=self._retry_after(
                    tenant, now, need_cells=cells + est_cells - limit_cells))

    def admit_session(self, tenant: str) -> None:
        """Raise when one more live session would break the cap
        (cluster-wide when gossiping)."""
        spec = self.registry.get(tenant)
        cap = spec["max_sessions"]
        if cap is None:
            return
        live = self.sessions_of(tenant) + self._remote(tenant)[2]
        if live + 1 > cap:
            raise QuotaExceeded(
                f"tenant {tenant!r} at max_sessions ({live} live, cap {cap})",
                tenant=tenant, retry_after_s=spec["window_s"])

    def _remote(self, tenant: str) -> Tuple[float, int, int]:
        fn = self.remote_spend
        if fn is None:
            return (0.0, 0, 0)
        return fn(tenant)

    def _retry_after(self, tenant: str, now: float, *,
                     need_device_s: float = 0.0, need_cells: int = 0) -> float:
        """Walk the oldest local charges until enough spend has aged out
        for the overshoot to fit; the answer is how long until that
        charge leaves the window.  When local history alone cannot free
        it (remote spend, or an estimate bigger than the whole quota),
        a full window is the honest answer."""
        window_s = self.registry.get(tenant)["window_s"]
        freed_s, freed_cells = 0.0, 0
        with self._lock:
            for t, d, c in self._events.get(tenant) or ():
                freed_s += d
                freed_cells += c
                if freed_s >= need_device_s and freed_cells >= need_cells:
                    return max(0.0, t + window_s - now)
        return window_s

    # -- gossip ------------------------------------------------------

    def window_snapshot(self) -> Dict[str, dict]:
        """This node's current window spend per tenant, for the gossip
        digest.  A full (absolute) snapshot, not a delta — peers keep
        only the latest per node, so sums stay exact under replay."""
        now = self.clock()
        out: Dict[str, dict] = {}
        with self._lock:
            live: Dict[str, int] = {}
            for t in self._sid_tenant.values():
                live[t] = live.get(t, 0) + 1
            for tenant in set(self._events) | set(live):
                self._prune(tenant, now)
                tot = self._totals.get(tenant) or (0.0, 0)
                out[tenant] = {
                    "device_s": tot[0],
                    "cells": tot[1],
                    "sessions": live.get(tenant, 0),
                }
        return out
