"""LRU cache of built engines, keyed by plan signature.

Setup is the expensive part of a board's life: planning, and on a new
rule the nvcc build of its kernel library (``ops/_build.py``).  Two
boards whose plans agree on everything the stepper depends on
(``mpi_tpu_torch.config.plan_signature``) share one
:class:`~mpi_tpu_torch.backends.cuda.Engine` and its warmed pass depths.
The cache makes "create a second board of the same shape" cost zero new
compiles: ``tests/test_torch_serve.py`` asserts it through the counters
here plus ``Engine.compile_count``.

A second, batched sub-cache rides along for the microbatch scheduler
(``serve/batch.py``): batched steppers keyed by ``(plan_signature, B)``
with their own hit/miss/eviction counters, so a second coalesced batch of
the same signature and width reuses the stepper handle (and, through
``Engine``'s per-``(depth, B)`` warm-up table, costs zero new compiles).

The cache also owns the per-signature **circuit breakers**: a plan
signature that keeps failing is *quarantined* here — the natural home,
because the signature IS the unit that shares one engine, so every
session riding a sick engine trips (and is protected by) the same
breaker.  ``breaker_threshold`` consecutive failures open the breaker;
``breaker_cooldown_s`` later it goes half-open and admits one trial
dispatch (success closes it, failure re-opens).  The session layer
consults ``breaker_allows`` before engine dispatches and degrades
affected sessions to the ``serial_np`` oracle while the breaker is open.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Callable, Tuple


class _Breaker:
    """Per-signature failure state (guarded by the cache lock)."""

    __slots__ = ("failures", "opened_at", "trips")

    def __init__(self):
        self.failures = 0
        self.opened_at = None           # monotonic time the breaker opened
        self.trips = 0


def signature_label(signature: tuple) -> str:
    """A compact human-readable tag for a plan signature (stats/healthz
    payloads must not ship a page of Rule repr per breaker)."""
    try:
        rows, cols, rule, boundary, backend, mesh = signature[:6]
        return (f"{rows}x{cols}/{backend}/{boundary}/"
                f"mesh{mesh[0]}x{mesh[1]}/{rule}")
    except Exception:  # noqa: BLE001 — labels are cosmetic, never fatal
        return str(signature)[:120]


class EngineCache:
    """Size-bounded LRU of ``signature -> engine`` with hit/miss/eviction
    counters (surfaced on ``/stats``).

    ``get_or_build`` runs the factory INSIDE the lock: concurrent create
    requests for the same signature must not both pay the compile — the
    second waits and hits.  Builds for different signatures serialize
    too; acceptable for a cache whose values may each take seconds of
    nvcc time to build (a per-signature lock table would only help the case
    where two *different* expensive plans arrive in the same instant).
    """

    def __init__(self, max_size: int = 8, *, breaker_threshold: int = 3,
                 breaker_cooldown_s: float = 30.0):
        if max_size < 1:
            raise ValueError(f"max_size must be >= 1, got {max_size}")
        if breaker_threshold < 1:
            raise ValueError(
                f"breaker_threshold must be >= 1, got {breaker_threshold}")
        if breaker_cooldown_s < 0:
            raise ValueError(
                f"breaker_cooldown_s must be >= 0, got {breaker_cooldown_s}")
        self.max_size = max_size
        self.breaker_threshold = int(breaker_threshold)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self._breakers: dict = {}
        # remote-open quarantines (cluster gossip): signature LABEL ->
        # {"peer", "expires"}.  Labels, not signature tuples — a peer
        # cannot ship a Rule object over the wire, and signature_label
        # is deterministic across processes for identical plans.
        self._remote_open: dict = {}
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.batched_hits = 0
        self.batched_misses = 0
        self.batched_evictions = 0
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, object]" = OrderedDict()
        # batched steppers are far cheaper than engines (a handle over an
        # engine the main table already holds), but the bound still keeps
        # a signature churn from growing the table without limit; one
        # entry per (signature, B) — 4 widths per signature by default
        self.batched_max_size = max_size * 4
        self._batched: "OrderedDict[tuple, object]" = OrderedDict()

    def get_or_build(self, signature: tuple,
                     factory: Callable[[], object]) -> Tuple[object, bool]:
        """(engine, hit).  On miss the factory's engine is inserted and the
        least-recently-used entry beyond ``max_size`` is dropped (its
        warmed buffers are freed when the last session using it
        lets go — sessions hold their own reference, so eviction never
        yanks an engine out from under a live board)."""
        with self._lock:
            eng = self._entries.get(signature)
            if eng is not None:
                self._entries.move_to_end(signature)
                self.hits += 1
                return eng, True
            self.misses += 1
            eng = factory()
            self._entries[signature] = eng
            while len(self._entries) > self.max_size:
                self._entries.popitem(last=False)
                self.evictions += 1
            return eng, False

    def get_or_build_batched(self, signature: tuple, B: int,
                             factory: Callable[[], object]) -> Tuple[object, bool]:
        """(stepper, hit) for the batched sub-cache, keyed
        ``(signature, B)`` — same inside-the-lock factory discipline as
        :meth:`get_or_build` (concurrent coalesced batches of one shape
        must not both build), same LRU beyond ``batched_max_size``."""
        key = (signature, int(B))
        with self._lock:
            stepper = self._batched.get(key)
            if stepper is not None:
                self._batched.move_to_end(key)
                self.batched_hits += 1
                return stepper, True
            self.batched_misses += 1
            stepper = factory()
            self._batched[key] = stepper
            while len(self._batched) > self.batched_max_size:
                self._batched.popitem(last=False)
                self.batched_evictions += 1
            return stepper, False

    def engines(self) -> list:
        """A snapshot of the cached engines (the obs layer aggregates
        their compile/dispatch counters at scrape time — live sessions
        may hold evicted engines beyond these, which the caller unions
        in)."""
        with self._lock:
            return list(self._entries.values())

    # -- circuit breaker ---------------------------------------------------

    def record_failure(self, signature: tuple) -> bool:
        """Count one engine failure against ``signature``; returns True
        when the breaker is (now) open — i.e. the signature is
        quarantined and the caller should degrade instead of retrying."""
        with self._lock:
            st = self._breakers.get(signature)
            if st is None:
                st = self._breakers[signature] = _Breaker()
            st.failures += 1
            if st.failures >= self.breaker_threshold:
                if st.opened_at is None:
                    st.trips += 1
                # (re)opening refreshes the cooldown clock, so a failed
                # half-open trial buys a full fresh cooldown
                st.opened_at = time.monotonic()
                return True
            return st.opened_at is not None

    def record_success(self, signature: tuple) -> None:
        """A successful engine dispatch closes the breaker and zeroes the
        consecutive-failure count (consecutive means consecutive)."""
        with self._lock:
            st = self._breakers.get(signature)
            if st is not None:
                st.failures = 0
                st.opened_at = None

    def breaker_state(self, signature: tuple) -> str:
        """'closed' | 'open' | 'half_open' (open, cooldown elapsed — one
        trial dispatch is admitted)."""
        with self._lock:
            return self._breaker_state_locked(signature)

    def _breaker_state_locked(self, signature: tuple) -> str:  # lint: disable=lock-discipline -- caller holds self._lock (_locked suffix contract)
        st = self._breakers.get(signature)
        if st is None or st.opened_at is None:
            return "closed"
        if time.monotonic() - st.opened_at >= self.breaker_cooldown_s:
            return "half_open"
        return "open"

    def breaker_allows(self, signature: tuple) -> bool:
        """May the caller dispatch on this signature's engine?  True when
        closed or half-open (the trial); False while open — locally OR
        on a gossiping peer (a sibling's poisoned plan is quarantined
        here before this process burns its own retries).  Remote opens
        have no half-open trial: only the origin dispatches trials, and
        its close propagates by the label leaving its next digest."""
        if self.breaker_state(signature) == "open":
            return False
        with self._lock:
            st = self._remote_open.get(signature_label(signature))
            return st is None or st["expires"] <= time.monotonic()

    def set_remote_open(self, peer: str, labels, ttl_s: float) -> None:
        """Replace ``peer``'s remote-open label set (one gossip digest's
        worth).  Replacement — not accumulation — is what makes the
        origin's breaker CLOSE propagate: a label absent from the next
        digest is dropped here.  ``ttl_s`` bounds how long a quarantine
        outlives its origin's last heartbeat."""
        now = time.monotonic()
        expires = now + max(0.0, float(ttl_s))
        with self._lock:
            self._remote_open = {
                lb: st for lb, st in self._remote_open.items()
                if st["peer"] != peer and st["expires"] > now
            }
            for lb in labels:
                self._remote_open[str(lb)] = {"peer": peer,
                                              "expires": expires}

    def breaker_stats(self) -> dict:
        with self._lock:
            open_, half = [], []
            trips = failures = 0
            for sig, st in self._breakers.items():
                trips += st.trips
                failures += st.failures
                state = self._breaker_state_locked(sig)
                if state == "open":
                    open_.append(signature_label(sig))
                elif state == "half_open":
                    half.append(signature_label(sig))
            now = time.monotonic()
            remote = sorted(lb for lb, st in self._remote_open.items()
                            if st["expires"] > now)
            return {
                "threshold": self.breaker_threshold,
                "cooldown_s": self.breaker_cooldown_s,
                "tracked_signatures": len(self._breakers),
                "trips": trips,
                "consecutive_failures": failures,
                "open": sorted(open_),
                "half_open": sorted(half),
                # quarantines learned from peers — kept apart from
                # "open" so gossip digests (which send "open") never
                # re-announce another node's state
                "remote_open": remote,
            }

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def __contains__(self, signature: tuple) -> bool:
        with self._lock:
            return signature in self._entries

    def stats(self) -> dict:
        with self._lock:
            return {
                "size": len(self._entries),
                "max_size": self.max_size,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "batched": {
                    "size": len(self._batched),
                    "max_size": self.batched_max_size,
                    "hits": self.batched_hits,
                    "misses": self.batched_misses,
                    "evictions": self.batched_evictions,
                },
            }
