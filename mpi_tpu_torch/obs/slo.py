"""Multi-window burn-rate SLO engine.

Declarative objectives — availability (non-5xx ratio), latency (p-high
under a threshold), freshness (age of the last committed dispatch) —
evaluated on every telemetry sampler tick as MULTI-WINDOW burn rates:

    burn(window) = observed bad-event ratio / allowed bad-event ratio

with a FAST (5 m) and a SLOW (1 h) window that must BOTH exceed a
threshold before the state worsens (the SRE-workbook discipline: the
slow window proves the burn is sustained, the fast window proves it is
still happening, so a transient spike and a long-recovered incident
both stay quiet).  Default thresholds: warning at burn 6, critical at
14.4 — at 14.4 a 99.9% budget is gone in ~2 days.  Freshness is a
staleness measure, not an error-budget ratio, so it gets absolute-style
thresholds instead (warning at 75% of ``max_age_s``, critical at 100%).

State transitions are asymmetric (flap damping): worsening applies
immediately — alert latency matters — while improving requires
``damp_evals`` consecutive calmer evaluations, so an objective
oscillating around a threshold cannot ring the transition counter on
every tick.  Each transition increments
``mpi_tpu_slo_transitions_total{slo,to}`` and emits an
``slo_transition`` trace event; current states render as
``mpi_tpu_slo_state{slo}`` (0 ok / 1 warning / 2 critical).

Everything here is armed-only (``Obs.arm_telemetry``): unarmed builds
register none of these families and the scrape stays byte-identical.
SLO state is ALERTING, not readiness — it never flips ``/healthz``'s
``ok`` (see README: a burning availability SLO with a healthy fallback
must not get the process restarted or ejected from a load balancer).
"""

from __future__ import annotations

import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.obs.timeseries import TelemetryRecorder

STATES = ("ok", "warning", "critical")
_RANK = {"ok": 0, "warning": 1, "critical": 2}

# fast/slow burn windows (seconds) — the 5m/1h pair from the digests'
# window vocabulary
FAST_S, SLOW_S = 300.0, 3600.0

# ratio-type objectives: budget multiples (14.4 burns a 30-day budget in
# ~2 days); freshness: fractions of max_age_s
_DEFAULT_BURN = {
    "availability": (6.0, 14.4),
    "latency": (6.0, 14.4),
    "freshness": (0.75, 1.0),
}

LATENCY_PATHS = ("dispatch", "http", "ticket_wait")


def default_objectives() -> List[dict]:
    """The built-in objectives used when ``--slo-file`` is not given."""
    return [
        {"name": "availability", "type": "availability", "target": 0.999},
        {"name": "dispatch-p99", "type": "latency", "path": "dispatch",
         "threshold_s": 1.0, "target": 0.99},
        {"name": "freshness", "type": "freshness", "max_age_s": 600.0},
    ]


def _normalize(obj: dict, seen: set) -> dict:
    if not isinstance(obj, dict):
        raise ConfigError(f"objective must be an object, got {obj!r}")
    kind = obj.get("type")
    if kind not in _DEFAULT_BURN:
        raise ConfigError(
            f"objective type must be one of {sorted(_DEFAULT_BURN)}, "
            f"got {kind!r}")
    name = obj.get("name") or kind
    if not isinstance(name, str) or not name:
        raise ConfigError(f"objective name must be a string, got {name!r}")
    if name in seen:
        raise ConfigError(f"duplicate objective name {name!r}")
    seen.add(name)
    out = {"name": name, "type": kind}
    if kind in ("availability", "latency"):
        target = obj.get("target")
        if not isinstance(target, (int, float)) or not 0.0 < target < 1.0:
            raise ConfigError(
                f"{name}: target must be a ratio in (0,1), got {target!r}")
        out["target"] = float(target)
    if kind == "latency":
        path = obj.get("path", "dispatch")
        if path not in LATENCY_PATHS:
            raise ConfigError(
                f"{name}: path must be one of {LATENCY_PATHS}, got {path!r}")
        thr = obj.get("threshold_s")
        if not isinstance(thr, (int, float)) or thr <= 0:
            raise ConfigError(
                f"{name}: threshold_s must be > 0, got {thr!r}")
        out["path"] = path
        out["threshold_s"] = float(thr)
    if kind == "freshness":
        age = obj.get("max_age_s")
        if not isinstance(age, (int, float)) or age <= 0:
            raise ConfigError(
                f"{name}: max_age_s must be > 0, got {age!r}")
        out["max_age_s"] = float(age)
    warn_d, crit_d = _DEFAULT_BURN[kind]
    warn = obj.get("warn_burn", warn_d)
    crit = obj.get("crit_burn", crit_d)
    for k, v in (("warn_burn", warn), ("crit_burn", crit)):
        if not isinstance(v, (int, float)) or v <= 0:
            raise ConfigError(f"{name}: {k} must be > 0, got {v!r}")
    if warn > crit:
        raise ConfigError(
            f"{name}: warn_burn {warn} must not exceed crit_burn {crit}")
    out["warn_burn"], out["crit_burn"] = float(warn), float(crit)
    unknown = set(obj) - set(out) - {"target", "path", "threshold_s",
                                     "max_age_s", "warn_burn", "crit_burn",
                                     "name", "type"}
    if unknown:
        raise ConfigError(f"{name}: unknown keys {sorted(unknown)}")
    return out


def normalize_objectives(raw) -> Tuple[List[dict], dict]:
    """Validate an ``--slo-file`` payload: either a bare list of
    objectives or ``{"objectives": [...], "damp_evals": N}``.  Returns
    ``(objectives, options)``; raises :class:`ConfigError` with the
    offending field named."""
    options: dict = {}
    if isinstance(raw, dict):
        if "objectives" not in raw:
            raise ConfigError('slo file object needs an "objectives" list')
        damp = raw.get("damp_evals")
        if damp is not None:
            if not isinstance(damp, int) or damp < 1:
                raise ConfigError(
                    f"damp_evals must be an int >= 1, got {damp!r}")
            options["damp_evals"] = damp
        unknown = set(raw) - {"objectives", "damp_evals"}
        if unknown:
            raise ConfigError(f"unknown top-level keys {sorted(unknown)}")
        raw = raw["objectives"]
    if not isinstance(raw, list) or not raw:
        raise ConfigError("slo file needs a non-empty objectives list")
    seen: set = set()
    return [_normalize(o, seen) for o in raw], options


def load_slo_file(path: str) -> Tuple[List[dict], dict]:
    try:
        with open(path, "r", encoding="utf-8") as f:
            raw = json.load(f)
    except OSError as e:
        raise ConfigError(f"cannot read slo file {path!r}: {e}") from e
    except ValueError as e:
        raise ConfigError(f"slo file {path!r} is not JSON: {e}") from e
    return normalize_objectives(raw)


class SloEngine:
    """Burn-rate evaluation + the flap-damped state machine.

    ``evaluate`` runs on the telemetry sampler's cadence (wired as
    ``TelemetryRecorder.after_sample``); everything it needs — window
    deltas, digests, dispatch age — is read from the recorder and the
    manager, never shadow-counted.
    """

    def __init__(self, objectives: List[dict],
                 telemetry: TelemetryRecorder,
                 manager=None, obs=None, damp_evals: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        # normalization is idempotent — callers may pass raw objective
        # dicts (defaults, tests) or already-validated slo-file output
        seen: set = set()
        objectives = [_normalize(o, seen) for o in objectives]
        self.objectives = objectives
        self._telemetry = telemetry
        self._manager = manager
        self._obs = obs
        self.damp_evals = max(1, int(damp_evals))
        self._clock = clock
        self._lock = threading.Lock()
        self._state: Dict[str, str] = {o["name"]: "ok" for o in objectives}
        # name -> (candidate calmer state, consecutive evals seen at it)
        self._streak: Dict[str, Tuple[str, int]] = {}
        self._transitions: Dict[Tuple[str, str], int] = {}
        self._burn: Dict[str, dict] = {o["name"]: {"fast": 0.0, "slow": 0.0}
                                       for o in objectives}
        self._detail: Dict[str, dict] = {o["name"]: {} for o in objectives}
        self._evals = 0
        # post-evaluate listeners, called OUTSIDE the lock with the
        # engine's worst state after every evaluation — the seam the
        # admission load-shedder hangs off; a raising listener is
        # swallowed (the sampler must never die because an actuator
        # hiccuped)
        self._listeners: List[Callable[[str], None]] = []

    # -- burn computation --------------------------------------------------

    def _burn_availability(self, obj: dict, now: float):
        tel = self._telemetry
        budget = 1.0 - obj["target"]
        burns, detail = {}, {}
        for wname, ws in (("fast", FAST_S), ("slow", SLOW_S)):
            total = tel.window_delta("http_requests", ws, now)
            bad = tel.window_delta("http_5xx", ws, now)
            ratio = (bad / total) if total > 0 else 0.0
            burns[wname] = ratio / budget
            detail[wname] = {"requests": total, "bad": bad,
                             "ratio": round(ratio, 6)}
        return burns["fast"], burns["slow"], detail

    def _burn_latency(self, obj: dict, now: float):
        dig = self._telemetry.digests[obj["path"]]
        budget = 1.0 - obj["target"]
        burns, detail = {}, {}
        for wname, ws in (("fast", FAST_S), ("slow", SLOW_S)):
            frac = dig.fraction_above(obj["threshold_s"], ws, now)
            burns[wname] = frac / budget
            detail[wname] = {"count": dig.count(ws, now),
                             "over_threshold": round(frac, 6)}
        return burns["fast"], burns["slow"], detail

    def _burn_freshness(self, obj: dict, now: float):
        mgr = self._manager
        age = mgr.last_dispatch_age_s() if mgr is not None else None
        # never-dispatched is "no data", not "stale": a process that has
        # served nothing yet has no freshness to lose
        burn = 0.0 if age is None else age / obj["max_age_s"]
        detail = {"age_s": None if age is None else round(age, 3),
                  "max_age_s": obj["max_age_s"]}
        return burn, burn, detail

    _BURN_FNS = {"availability": _burn_availability,
                 "latency": _burn_latency,
                 "freshness": _burn_freshness}

    # -- the state machine -------------------------------------------------

    @staticmethod
    def _classify(obj: dict, fast: float, slow: float) -> str:
        # both windows must agree before the state worsens
        if fast >= obj["crit_burn"] and slow >= obj["crit_burn"]:
            return "critical"
        if fast >= obj["warn_burn"] and slow >= obj["warn_burn"]:
            return "warning"
        return "ok"

    def evaluate(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        for obj in self.objectives:
            name = obj["name"]
            fast, slow, detail = self._BURN_FNS[obj["type"]](self, obj, now)
            target = self._classify(obj, fast, slow)
            with self._lock:
                self._burn[name] = {"fast": fast, "slow": slow}
                self._detail[name] = detail
                cur = self._state[name]
                if _RANK[target] > _RANK[cur]:
                    # worsening: immediate — alert latency matters
                    self._transition(name, cur, target, fast, slow)
                elif _RANK[target] < _RANK[cur]:
                    # improving: hold down until damp_evals consecutive
                    # calmer evaluations agree (flap damping)
                    cand, n = self._streak.get(name, (None, 0))
                    n = n + 1 if cand == target else 1
                    if n >= self.damp_evals:
                        self._transition(name, cur, target, fast, slow)
                        self._streak.pop(name, None)
                    else:
                        self._streak[name] = (target, n)
                else:
                    self._streak.pop(name, None)
        with self._lock:
            self._evals += 1
        if self._listeners:
            worst = self.worst()
            for fn in list(self._listeners):
                try:
                    fn(worst)
                except Exception:  # noqa: BLE001 — see _listeners above
                    pass

    def _transition(self, name: str, frm: str, to: str,
                    fast: float, slow: float) -> None:
        # caller holds the lock
        self._state[name] = to
        key = (name, to)
        self._transitions[key] = self._transitions.get(key, 0) + 1
        if self._obs is not None:
            self._obs.event("slo_transition", slo=name, to=to,
                            burn_fast=round(fast, 3),
                            burn_slow=round(slow, 3), **{"from": frm})

    # -- readouts ----------------------------------------------------------

    def worst(self) -> str:
        with self._lock:
            return max(self._state.values(), key=_RANK.__getitem__,
                       default="ok")

    def add_listener(self, fn: Callable[[str], None]) -> None:
        """Subscribe to post-evaluate worst-state callbacks (the
        admission shedder's feed).  Idempotent registration is the
        caller's problem; the engine just calls everything in order."""
        self._listeners.append(fn)

    def transitions_total(self) -> int:
        with self._lock:
            return sum(self._transitions.values())

    def snapshot(self) -> dict:
        """The `/slo` payload (sans cluster block)."""
        tel = self._telemetry
        with self._lock:
            states = dict(self._state)
            burns = {n: dict(b) for n, b in self._burn.items()}
            details = {n: dict(d) for n, d in self._detail.items()}
            transitions = sorted(
                (n, to, c) for (n, to), c in self._transitions.items())
            evals = self._evals
        slos = []
        for obj in self.objectives:
            name = obj["name"]
            row = {"name": name, "type": obj["type"],
                   "state": states[name],
                   "burn": {w: round(v, 4)
                            for w, v in burns[name].items()},
                   "thresholds": {"warn": obj["warn_burn"],
                                  "crit": obj["crit_burn"]},
                   "detail": details[name]}
            for k in ("target", "path", "threshold_s", "max_age_s"):
                if k in obj:
                    row[k] = obj[k]
            slos.append(row)
        return {
            "interval_s": tel.interval_s,
            "evals": evals,
            "windows_s": {"fast": FAST_S, "slow": SLOW_S},
            "worst": max(states.values(), key=_RANK.__getitem__,
                         default="ok"),
            "slos": slos,
            "transitions_total": sum(c for _, _, c in transitions),
            "transitions": [{"slo": n, "to": to, "count": c}
                            for n, to, c in transitions],
            "windows": tel.windows_summary(),
        }

    def compact(self) -> dict:
        """The gossiped per-node SLO block: current states, the
        CUMULATIVE transition count (so the roll-up can sum snapshots
        exactly, the ledger discipline), and a light 5m window summary."""
        with self._lock:
            states = dict(self._state)
            transitions = sum(self._transitions.values())
            evals = self._evals
        windows = {}
        for path, dig in sorted(self._telemetry.digests.items()):
            s = dig.summary(FAST_S)
            windows[path] = {"count": s["count"], "p99": s["p99"]}
        return {"worst": max(states.values(), key=_RANK.__getitem__,
                             default="ok"),
                "states": states, "transitions": transitions,
                "evals": evals, "windows": windows}

    def health_block(self) -> dict:
        """`/healthz`'s ``slo`` block: worst state + the burning
        objectives.  Alerting only — the caller must NOT fold this into
        ``ok`` (alerting is not readiness)."""
        with self._lock:
            burning = sorted(n for n, s in self._state.items() if s != "ok")
            worst = max(self._state.values(), key=_RANK.__getitem__,
                        default="ok")
        return {"worst": worst, "burning": burning}

    # -- armed-only registry families --------------------------------------

    def bind_metrics(self, m) -> None:
        def _states():
            with self._lock:
                return [({"slo": n}, float(_RANK[s]))
                        for n, s in sorted(self._state.items())]

        m.gauge_fn("mpi_tpu_slo_state",
                   "SLO state per objective (0 ok, 1 warning, 2 critical)",
                   _states)

        def _transitions():
            with self._lock:
                return [({"slo": n, "to": to}, c)
                        for (n, to), c in sorted(self._transitions.items())]

        m.counter_fn("mpi_tpu_slo_transitions_total",
                     "SLO state transitions by objective and destination "
                     "state",
                     _transitions)
