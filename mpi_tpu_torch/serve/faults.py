"""Deterministic fault injection at the engine dispatch boundary.

Every recovery path in the serve layer — retry with backoff, the
circuit breaker, host-backend degradation, the dispatch watchdog —
exists because a device dispatch can raise, hang, or stall.  None of
those failures can be produced on demand by real hardware in a unit
test, so this module fakes them *deterministically*: a
:class:`FaultPlan` parsed from a spec string (``SessionManager(faults=
SPEC)``) decides, purely from the dispatch ordinal,
whether the Nth engine dispatch raises :class:`InjectedFault`, hangs
(sleeps, then raises — the step must never half-commit), or delays
(sleeps, then proceeds normally).

The hook point is :meth:`mpi_tpu_torch.backends.cuda.Engine.step` /
``step_batched``: the serve layer installs
:meth:`FaultInjector.engine_hook` on every engine it hands to a
session, so faults fire exactly where a sick device would — before any
buffer is taken or any kernel launched, with the session's grid still
intact.  (Real failures can also corrupt the consumed input buffer; the
degradation path never trusts the device grid for exactly that reason —
it replays from the last checkpoint instead.)

A cluster layer hooks the same plans at its two
network seams: ``gossip`` (one outbound digest send per peer per round)
and ``proxy`` (one outbound forwarded-request attempt, retries
included).  Network sites get network modes — ``drop`` severs that one
attempt (the caller sees the peer as unreachable), ``delay`` sleeps
then proceeds, and ``partition`` drops outbound *and* cuts inbound at
the same site (:meth:`FaultInjector.inbound_cut`) while the clause
still covers the next outbound ordinal — a deterministic, symmetric
network split that heals exactly when the clause range is spent.

The storage plane (``serve/recovery.py``) hooks the same plans at its
single IO choke point, :meth:`StateStore._io`: ``io-write`` (one
buffered write of a record envelope or journal entry), ``io-fsync``
(the flush+fsync making it durable), and ``io-replace`` (the atomic
rename publishing a record).  IO sites get IO modes — ``raise`` fails
the call with ``EIO``, ``enospc`` fails it with ``ENOSPC`` (the
full-disk path), ``delay`` sleeps then proceeds, and ``torn:frac``
makes the write stop after ``frac`` of its bytes *and actually flushes
the torn prefix to disk* before failing — the exact on-disk shape a
crash mid-write leaves, which is what the CRC envelopes and journal
tail-truncation exist to survive.

Spec grammar (comma-separated clauses; a leading ``seed=N`` clause
seeds the probabilistic selector)::

    SPEC   := [ 'seed=' int ',' ] clause ( ',' clause )*
    clause := site ':' sel ':' mode [ ':' arg ]
    site   := 'step' | 'batched' | 'any' | 'gossip' | 'proxy'
            | 'io-write' | 'io-fsync' | 'io-replace'
    sel    := N | N'+' | N'-'M | '*' | 'p'FLOAT
    mode   := 'raise' | 'hang' | 'delay'          (engine sites)
            | 'drop' | 'delay' | 'partition'      (network sites)
            | 'raise' | 'torn' | 'enospc' | 'delay'   (io sites)

``sel`` counts dispatches at that site from 1 (``any`` counts both
engine sites together; network and io sites each count alone): ``3``
fires on exactly the 3rd dispatch, ``3+`` from the 3rd on, ``2-4`` on
the 2nd through 4th, ``*`` on every one, and ``p0.25`` on each with
probability 0.25 drawn from a ``random.Random`` seeded by the plan's
``seed=`` clause (default 0) — same seed, same dispatch order, same
faults, every run.  ``arg`` is seconds for ``hang``/``delay`` (defaults
30 and 0.05) and the byte fraction in [0, 1] for ``torn`` (default
0.5); ``raise``, ``drop``, ``partition``, and ``enospc`` ignore it.

Examples::

    --inject-faults 'step:1-3:raise'       # first three solo dispatches fail
    --inject-faults 'any:2:hang:5'         # 2nd dispatch wedges for 5 s
    --inject-faults 'seed=7,step:p0.1:raise'
    --inject-faults 'gossip:1-8:partition' # both gossip directions cut until
                                           # 8 outbound sends have been eaten
    --inject-faults 'proxy:1:drop'         # first proxy hop fails (retry path)
    --inject-faults 'io-write:2:torn:0.25' # 2nd write stops at 25% of bytes
    --inject-faults 'io-fsync:1+:enospc'   # the disk is full from here on
"""

from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from mpi_tpu_torch.config import ConfigError

_ENGINE_SITES = ("step", "batched", "any")
_NET_SITES = ("gossip", "proxy")
_IO_SITES = ("io-write", "io-fsync", "io-replace")
_SITES = _ENGINE_SITES + _NET_SITES + _IO_SITES
_ENGINE_MODES = ("raise", "hang", "delay")
_NET_MODES = ("drop", "delay", "partition")
_IO_MODES = ("raise", "torn", "enospc", "delay")
_MODES = ("raise", "hang", "delay", "drop", "partition", "torn", "enospc")
_DEFAULT_SECONDS = {"raise": 0.0, "hang": 30.0, "delay": 0.05,
                    "drop": 0.0, "partition": 0.0,
                    "torn": 0.5, "enospc": 0.0}


class InjectedFault(RuntimeError):
    """The error a 'raise' (or an ended 'hang') fault throws — a stand-in
    for whatever a sick device dispatch would have raised."""


class InjectedNetworkFault(RuntimeError):
    """What a 'drop' or 'partition' clause throws at a network site —
    the cluster layer maps it to ``PeerUnreachable``, so an injected
    split exercises exactly the real unreachable-peer paths."""


class InjectedIOFault(OSError):
    """What an io-site clause throws — an ``OSError`` with a real errno
    (``EIO`` for raise/torn, ``ENOSPC`` for enospc), so the storage
    plane's degradation machinery cannot special-case injected failures
    apart from kernel ones."""

    def __init__(self, eno: int, msg: str):
        super().__init__(eno, msg)


@dataclass(frozen=True)
class _Clause:
    site: str                       # step | batched | any
    lo: Optional[int]               # 1-based dispatch range [lo, hi]
    hi: Optional[int]               # None with lo=None means probabilistic
    prob: Optional[float]
    mode: str                       # raise | hang | delay
    seconds: float

    def matches(self, nth: int, draw: Optional[float]) -> bool:
        if self.prob is not None:
            return draw is not None and draw < self.prob
        if self.lo is None:
            return True                             # '*'
        return self.lo <= nth <= (self.hi if self.hi is not None else nth)


class FaultPlan:
    """Parsed, immutable fault spec; :class:`FaultInjector` executes it."""

    def __init__(self, clauses: List[_Clause], seed: int = 0,
                 spec: str = ""):
        self.clauses = tuple(clauses)
        self.seed = seed
        self.spec = spec

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        clauses, seed = [], 0
        for raw in str(spec).split(","):
            raw = raw.strip()
            if not raw:
                continue
            if raw.startswith("seed="):
                try:
                    seed = int(raw[5:])
                except ValueError:
                    raise ConfigError(f"bad fault seed clause {raw!r}")
                continue
            parts = raw.split(":")
            if len(parts) not in (3, 4):
                raise ConfigError(
                    f"bad fault clause {raw!r}; want site:sel:mode[:seconds]")
            site, sel, mode = parts[0], parts[1], parts[2]
            if site not in _SITES:
                raise ConfigError(
                    f"bad fault site {site!r}; one of {_SITES}")
            if mode not in _MODES:
                raise ConfigError(
                    f"bad fault mode {mode!r}; one of {_MODES}")
            allowed = (_NET_MODES if site in _NET_SITES
                       else _IO_MODES if site in _IO_SITES
                       else _ENGINE_MODES)
            if mode not in allowed:
                raise ConfigError(
                    f"fault mode {mode!r} is not valid at site {site!r}; "
                    f"one of {allowed}")
            lo = hi = prob = None
            try:
                if sel == "*":
                    pass
                elif sel.startswith("p"):
                    prob = float(sel[1:])
                    if not 0.0 <= prob <= 1.0:
                        raise ValueError
                elif sel.endswith("+"):
                    lo, hi = int(sel[:-1]), None
                elif "-" in sel:
                    a, b = sel.split("-")
                    lo, hi = int(a), int(b)
                else:
                    lo = hi = int(sel)
                if lo is not None and lo < 1:
                    raise ValueError
            except ValueError:
                raise ConfigError(
                    f"bad fault selector {sel!r}; want N, N+, N-M, *, or pF")
            try:
                seconds = (float(parts[3]) if len(parts) == 4
                           else _DEFAULT_SECONDS[mode])
            except ValueError:
                raise ConfigError(f"bad fault seconds in {raw!r}")
            if seconds < 0:
                raise ConfigError(f"fault seconds must be >= 0 in {raw!r}")
            if mode == "torn" and not 0.0 <= seconds <= 1.0:
                raise ConfigError(
                    f"torn fraction must be in [0, 1] in {raw!r}")
            clauses.append(_Clause(site, lo, hi, prob, mode, seconds))
        if not clauses:
            raise ConfigError(f"fault spec {spec!r} has no clauses")
        return cls(clauses, seed=seed, spec=str(spec))


class FaultInjector:
    """Executes a :class:`FaultPlan` against the live dispatch stream.

    Thread-safe: the counter/RNG advance under a lock, the sleep and the
    raise happen outside it (a hanging fault must wedge only its own
    dispatch, not the injector).  One injector serves every engine in
    the process — the serve layer installs :meth:`engine_hook` as
    ``Engine.fault_hook`` on each engine it creates or reuses."""

    def __init__(self, plan: FaultPlan):
        self.plan = plan
        self._lock = threading.Lock()
        self._counts = {"step": 0, "batched": 0, "any": 0,
                        "gossip": 0, "proxy": 0,
                        "io-write": 0, "io-fsync": 0, "io-replace": 0}
        self._rng = random.Random(plan.seed)
        self.injected = {"raise": 0, "hang": 0, "delay": 0,
                         "drop": 0, "partition": 0,
                         "torn": 0, "enospc": 0}

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        return cls(FaultPlan.parse(spec))

    def engine_hook(self, site: str) -> None:
        """Called by the engine immediately before a device dispatch;
        ``site`` is 'step' or 'batched'.  Raises :class:`InjectedFault`
        (raise/hang modes) or returns after an optional delay."""
        action: Optional[Tuple[str, float, str]] = None
        with self._lock:
            self._counts[site] += 1
            self._counts["any"] += 1
            for c in self.plan.clauses:
                if c.site not in (site, "any"):
                    continue
                nth = self._counts[c.site if c.site != "any" else "any"]
                draw = self._rng.random() if c.prob is not None else None
                if c.matches(nth, draw):
                    action = (c.mode, c.seconds,
                              f"injected {c.mode} at {site} dispatch "
                              f"#{self._counts[site]}")
                    self.injected[c.mode] += 1
                    break
        if action is None:
            return
        mode, seconds, msg = action
        if mode == "delay":
            time.sleep(seconds)
            return
        if mode == "hang":
            # sleep out the hang, then FAIL: the dispatch must never
            # half-commit a step the client was already told timed out
            time.sleep(seconds)
        raise InjectedFault(msg)

    def net_hook(self, site: str, peer: str = "?") -> None:
        """Called by the cluster layer immediately before an outbound
        network attempt; ``site`` is 'gossip' or 'proxy'.  Raises
        :class:`InjectedNetworkFault` (drop/partition) or returns after
        an optional delay — same counter-under-lock, effect-outside-lock
        discipline as :meth:`engine_hook`."""
        action: Optional[Tuple[str, float, str]] = None
        with self._lock:
            self._counts[site] += 1
            nth = self._counts[site]
            for c in self.plan.clauses:
                if c.site != site:
                    continue
                draw = self._rng.random() if c.prob is not None else None
                if c.matches(nth, draw):
                    action = (c.mode, c.seconds,
                              f"injected {c.mode} at {site} attempt "
                              f"#{nth} (peer {peer})")
                    self.injected[c.mode] += 1
                    break
        if action is None:
            return
        mode, seconds, msg = action
        if mode == "delay":
            time.sleep(seconds)
            return
        raise InjectedNetworkFault(msg)

    def io_hook(self, site: str) -> Optional[float]:
        """Called by :meth:`StateStore._io` immediately before a storage
        syscall; ``site`` is 'io-write', 'io-fsync', or 'io-replace'.
        Raises :class:`InjectedIOFault` (raise → ``EIO``, enospc →
        ``ENOSPC``), sleeps through a delay, or returns the torn byte
        fraction for the store to execute (the tear must happen at the
        write itself so the torn prefix really lands on disk) — None
        means proceed normally.  Same counter-under-lock,
        effect-outside-lock discipline as the other hooks."""
        action: Optional[Tuple[str, float, str]] = None
        with self._lock:
            self._counts[site] += 1
            nth = self._counts[site]
            for c in self.plan.clauses:
                if c.site != site:
                    continue
                draw = self._rng.random() if c.prob is not None else None
                if c.matches(nth, draw):
                    action = (c.mode, c.seconds,
                              f"injected {c.mode} at {site} call #{nth}")
                    self.injected[c.mode] += 1
                    break
        if action is None:
            return None
        mode, seconds, msg = action
        if mode == "delay":
            time.sleep(seconds)
            return None
        if mode == "torn":
            return seconds              # the byte fraction to keep
        if mode == "enospc":
            raise InjectedIOFault(errno.ENOSPC, msg)
        raise InjectedIOFault(errno.EIO, msg)

    def inbound_cut(self, site: str) -> bool:
        """True while a ``partition`` clause at ``site`` still covers
        the NEXT outbound ordinal — inbound refusal tracks the same
        deterministic window as outbound drops, so the split is
        symmetric and heals exactly when the clause range is spent.
        (Probabilistic partition clauses never cut inbound: there is no
        ordinal to anchor the draw to.)"""
        with self._lock:
            nxt = self._counts.get(site, 0) + 1
            for c in self.plan.clauses:
                if (c.site == site and c.mode == "partition"
                        and c.prob is None and c.matches(nxt, None)):
                    return True
        return False

    def stats(self) -> dict:
        with self._lock:
            return {
                "spec": self.plan.spec,
                "seed": self.plan.seed,
                "dispatches": dict(self._counts),
                "injected": dict(self.injected),
            }
