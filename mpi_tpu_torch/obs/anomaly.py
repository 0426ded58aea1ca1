"""Anomaly-triggered profiling.

An on-demand profile (``obs/profile.py:run_profile``) needs an operator
already watching when the regression happens.  This module watches instead: every committed
dispatch feeds a per-plan-signature :class:`~mpi_tpu_torch.obs.timeseries.
WindowedDigest`, and on the telemetry cadence the detector compares the
RECENT median (both the 1m and 5m windows must agree — the SLO
engine's two-window discipline) against the 1h baseline median of the
same signature.  The ratio test is rank-relative, so it is unitless
and self-calibrating per plan: a 64×64 toy and a 2¹⁵×2¹⁵ production
grid drift on the same threshold.  Both directions are detected —
``slow`` (regression) and ``fast`` (suspicious speedup: work silently
skipped, wrong rung) — with asymmetric flap damping copied from
``slo.py``: entering an anomalous state is immediate, leaving it takes
``damp_evals`` consecutive calm evaluations.

On a transition into an anomalous state the detector emits ONE
``dispatch_anomaly`` trace event carrying exemplar trace ids of the
slowest recent dispatches (so the operator joins straight into the
flight records and the distributed trace), appends an episode to the
anomalies ring, and — for ``slow`` drift only, when a ``profile_dir``
is armed — starts ONE bounded ``torch.profiler`` capture
(``run_profile``) into a rotated ``anomaly-*`` directory.  Duty-cycling is
enforced twice: a cooldown between captures (never back-to-back) and a
retention cap pruning the oldest capture directories, so an anomalous
week cannot fill the disk.

Armed-only (``Obs.arm_flight(anomaly=...)``); unarmed builds register
none of these families.
"""

from __future__ import annotations

import os
import shutil
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from mpi_tpu_torch.obs.timeseries import WindowedDigest

__all__ = ["AnomalyDetector"]

STATES = ("ok", "fast", "slow")
_RANK = {"ok": 0, "fast": 1, "slow": 2}

# recent windows that must BOTH drift before a transition (5m proves it
# is sustained, 1m proves it is still happening), vs the 1h baseline
RECENT_WINDOWS: Tuple[Tuple[str, float], ...] = (("1m", 60.0),
                                                 ("5m", 300.0))
BASELINE_S = 3600.0


def _default_capture(logdir: str, secs: float) -> None:
    """Fire-and-forget bounded capture on a daemon thread, through
    ``run_profile`` so the endpoint's process-global ``_profile_lock``
    serializes us against an operator-initiated capture."""
    from mpi_tpu_torch.obs.profile import run_profile

    threading.Thread(target=run_profile, args=(logdir, secs),
                     name="mpi-tpu-anomaly-capture", daemon=True).start()


class AnomalyDetector:
    """Per-signature rank-relative drift detection + capture arming.

    ``observe`` is the flight recorder's ``on_record`` feed (armed-only
    hot path: one digest observe + one deque append).  ``evaluate``
    runs on the telemetry sampler's cadence, chained after the SLO
    evaluation.
    """

    def __init__(self, obs, ratio: float = 2.0, damp_evals: int = 3,
                 min_recent: int = 8, min_baseline: int = 32,
                 profile_dir: Optional[str] = None,
                 capture_s: float = 2.0, cooldown_s: float = 600.0,
                 retention: int = 4,
                 clock: Callable[[], float] = time.monotonic,
                 capture_fn: Optional[Callable[[str, float], None]] = None):
        if ratio <= 1.0:
            raise ValueError(f"drift ratio must be > 1, got {ratio}")
        self._obs = obs
        self.ratio = float(ratio)
        self.damp_evals = max(1, int(damp_evals))
        self.min_recent = max(1, int(min_recent))
        self.min_baseline = max(1, int(min_baseline))
        self.profile_dir = profile_dir
        self.capture_s = float(capture_s)
        self.cooldown_s = float(cooldown_s)
        self.retention = max(1, int(retention))
        self._clock = clock
        self._capture_fn = capture_fn or _default_capture
        self._lock = threading.Lock()
        self._digests: Dict[str, WindowedDigest] = {}
        # per sig: recent (wall_s, trace_id) pairs — exemplar pool for
        # the dispatch_anomaly event (slowest first at emission)
        self._recent: Dict[str, deque] = {}
        self._state: Dict[str, str] = {}
        self._streak: Dict[str, int] = {}
        self._episodes: deque = deque(maxlen=64)
        self._counts: Dict[str, int] = {}
        self._captures = 0
        self._capture_seq = 0
        self._last_capture: Optional[float] = None
        self._evals = 0

    # -- the hot-path feed -----------------------------------------------

    def observe(self, sig: Optional[str], wall_s: float,
                trace_id: Optional[str] = None) -> None:
        if sig is None:
            return
        with self._lock:
            dig = self._digests.get(sig)
            if dig is None:
                dig = self._digests[sig] = WindowedDigest(clock=self._clock)
                self._recent[sig] = deque(maxlen=8)
                self._state[sig] = "ok"
            recent = self._recent[sig]
        dig.observe(wall_s)
        recent.append((wall_s, trace_id))

    # -- evaluation ------------------------------------------------------

    def _classify(self, dig: WindowedDigest, now: float):
        base_n = dig.count(BASELINE_S, now)
        base = dig.quantile(0.5, BASELINE_S, now)
        detail = {"baseline_p50": base, "baseline_count": base_n,
                  "ratios": {}}
        if base is None or base <= 0 or base_n < self.min_baseline:
            return "ok", detail
        slow = fast = True
        for wname, ws in RECENT_WINDOWS:
            n = dig.count(ws, now)
            q = dig.quantile(0.5, ws, now)
            if n < self.min_recent or q is None:
                return "ok", detail
            r = q / base
            detail["ratios"][wname] = round(r, 4)
            if wname == "1m":
                detail["recent_p50"] = q
            slow = slow and r >= self.ratio
            fast = fast and r <= 1.0 / self.ratio
        if slow:
            return "slow", detail
        if fast:
            return "fast", detail
        return "ok", detail

    def evaluate(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        with self._lock:
            sigs = list(self._digests.items())
        for sig, dig in sigs:
            target, detail = self._classify(dig, now)
            with self._lock:
                cur = self._state[sig]
                if target != "ok" and target != cur:
                    # entering (or re-classifying) an anomaly: immediate
                    self._state[sig] = target
                    self._streak.pop(sig, None)
                    episode = self._episode(sig, target, detail, now)
                else:
                    episode = None
                    if target == "ok" and cur != "ok":
                        # leaving: damp_evals consecutive calm evals
                        n = self._streak.get(sig, 0) + 1
                        if n >= self.damp_evals:
                            self._state[sig] = "ok"
                            self._streak.pop(sig, None)
                        else:
                            self._streak[sig] = n
                    else:
                        self._streak.pop(sig, None)
            if episode is not None:
                self._emit(episode)
        with self._lock:
            self._evals += 1

    def _episode(self, sig: str, direction: str, detail: dict,
                 now: float) -> dict:
        # caller holds the lock
        pool = sorted(self._recent.get(sig, ()),
                      key=lambda p: p[0], reverse=True)
        exemplars = [tid for _, tid in pool if tid is not None][:3]
        self._counts[direction] = self._counts.get(direction, 0) + 1
        ep = {
            "sig": sig,
            "direction": direction,
            "t": now,
            "ratios": detail.get("ratios", {}),
            "baseline_p50": detail.get("baseline_p50"),
            "recent_p50": detail.get("recent_p50"),
            "baseline_count": detail.get("baseline_count"),
            "exemplars": exemplars,
            "capture_dir": None,
        }
        self._episodes.append(ep)
        return ep

    def _emit(self, ep: dict) -> None:
        if ep["direction"] == "slow":
            ep["capture_dir"] = self._maybe_capture(ep["t"])
        if self._obs is not None:
            base = ep["baseline_p50"]
            recent = ep["recent_p50"]
            self._obs.event(
                "dispatch_anomaly", sig=ep["sig"],
                direction=ep["direction"], ratios=ep["ratios"],
                baseline_p50=None if base is None else round(base, 9),
                recent_p50=None if recent is None else round(recent, 9),
                exemplars=ep["exemplars"],
                capture=ep["capture_dir"])

    # -- capture duty cycle ----------------------------------------------

    def _maybe_capture(self, now: float) -> Optional[str]:
        """Arm at most one bounded capture per cooldown window; prune
        the oldest ``anomaly-*`` capture dirs past the retention cap.
        Returns the capture directory, or None when disarmed/cooling."""
        with self._lock:
            if self.profile_dir is None:
                return None
            if (self._last_capture is not None
                    and now - self._last_capture < self.cooldown_s):
                return None
            # stamp BEFORE starting: a slow capture must not let the
            # next evaluation arm a back-to-back one
            self._last_capture = now
            self._capture_seq += 1
            seq = self._capture_seq
            self._captures += 1
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(self.profile_dir,
                            f"anomaly-{stamp}-{seq:03d}")
        try:
            self._prune_captures(keep_for=path)
            os.makedirs(path, exist_ok=True)
        except OSError:
            return None
        self._capture_fn(path, self.capture_s)
        return path

    def _prune_captures(self, keep_for: Optional[str] = None) -> None:
        """Drop the oldest ``anomaly-*`` dirs so at most ``retention``
        captures (including the one about to be written) remain."""
        try:
            names = sorted(n for n in os.listdir(self.profile_dir)
                           if n.startswith("anomaly-"))
        except OSError:
            return
        if keep_for is not None:
            names = [n for n in names
                     if n != os.path.basename(keep_for)]
        while len(names) >= self.retention:
            victim = names.pop(0)
            shutil.rmtree(os.path.join(self.profile_dir, victim),
                          ignore_errors=True)

    # -- readouts --------------------------------------------------------

    def snapshot(self) -> dict:
        """The ``GET /debug/anomalies`` payload."""
        with self._lock:
            states = dict(self._state)
            episodes = list(self._episodes)
            counts = dict(self._counts)
            evals = self._evals
            captures = self._captures
            digs = list(self._digests.items())
        signatures = []
        for sig, dig in sorted(digs):
            s = dig.summary(BASELINE_S)
            signatures.append({"sig": sig, "state": states.get(sig, "ok"),
                               "baseline_count": s["count"],
                               "baseline_p50": s["p50"]})
        return {
            "ratio": self.ratio,
            "damp_evals": self.damp_evals,
            "min_recent": self.min_recent,
            "min_baseline": self.min_baseline,
            "windows_s": {w: s for w, s in RECENT_WINDOWS},
            "baseline_s": BASELINE_S,
            "capture": {
                "profile_dir": self.profile_dir,
                "capture_s": self.capture_s,
                "cooldown_s": self.cooldown_s,
                "retention": self.retention,
                "captures": captures,
            },
            "evals": evals,
            "anomalies_total": counts,
            "signatures": signatures,
            "episodes": episodes,
        }

    def stats(self) -> dict:
        with self._lock:
            return {"signatures": len(self._digests),
                    "episodes": len(self._episodes),
                    "captures": self._captures,
                    "evals": self._evals}

    # -- armed-only registry families ------------------------------------

    def bind_metrics(self, m) -> None:
        def _totals():
            with self._lock:
                return [({"direction": d}, c)
                        for d, c in sorted(self._counts.items())]

        m.counter_fn("mpi_tpu_dispatch_anomalies_total",
                     "Dispatch-latency drift episodes by direction "
                     "(present only when --anomaly-detect arms the "
                     "detector)",
                     _totals)

        def _states():
            with self._lock:
                return [({"sig": s}, float(_RANK[st]))
                        for s, st in sorted(self._state.items())]

        m.gauge_fn("mpi_tpu_anomaly_state",
                   "Per-signature drift state (0 ok, 1 fast, 2 slow)",
                   _states)
        m.counter_fn("mpi_tpu_anomaly_captures_total",
                     "Profiler captures armed by the anomaly detector",
                     lambda: self._captures)
