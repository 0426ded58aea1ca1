"""Sliding-window quantile digests + the in-process telemetry recorder
(the history the SLO engine reads).

The scrape surface (`/metrics`) answers "now"; this module gives the
process a bounded MEMORY of its own recent behaviour so the SLO engine
(:mod:`.slo`) and `/debug/timeseries` can answer "over the last
1m/5m/1h" without an external Prometheus:

* :class:`WindowedDigest` — a DDSketch-style log-bucket quantile digest
  over a ring of 5-second time slices.  Bucket bounds grow geometrically
  (``gamma = (1+alpha)/(1-alpha)``), so any quantile estimate is within
  ``alpha`` (default 5%) RELATIVE error of a true sample at that rank —
  the bound ``tests/test_slo.py`` checks against ``numpy.percentile`` on
  adversarial (bimodal, heavy-tail) distributions.  Slices rotate lazily
  off the injected clock (no timer thread per digest), windows are
  accurate to one slice (±5 s), and memory is bounded: ≤720 slices of
  sparse bucket-count dicts (~300 possible buckets across 13 decades).
* :class:`TelemetryRecorder` — a fixed-capacity ring buffer of sampled
  registry series (counters recorded cumulatively, rendered as rates;
  gauges recorded raw), one sample per ``interval_s`` tick
  from a daemon thread.  Sampling READS the authoritative instruments
  (``Counter.total`` / ``Histogram.total_count`` / ``_FnMetric.read_sum``)
  — the no-shadow-counting rule extends to history.

Everything here exists only when armed: the recorder (and its one
``mpi_tpu_telemetry_samples_total`` family) is constructed by
``Obs.arm_telemetry``, so the unarmed
scrape text and trace JSONL stay byte-identical to the pre-telemetry
build.
"""

from __future__ import annotations

import math
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

# the window vocabulary shared by digests, /debug/timeseries, and the
# SLO engine's fast/slow burn windows
WINDOWS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0), ("5m", 300.0), ("1h", 3600.0))
WINDOW_S: Dict[str, float] = dict(WINDOWS)

# values at or below this clamp share one bucket ("effectively zero" —
# latencies this small are below clock resolution anyway)
_MIN_VALUE = 1e-9


class WindowedDigest:
    """Quantiles over a sliding time window, log-bucket quantization.

    ``observe`` is O(1): one clock read, one log, one dict increment
    under the digest lock — armed-only hot-path cost.  Queries merge the
    slices younger than the window and walk the sorted sparse buckets.
    """

    SLICE_S = 5.0

    def __init__(self, alpha: float = 0.05, max_window_s: float = 3600.0,
                 clock: Callable[[], float] = time.monotonic):
        if not 0.0 < alpha < 1.0:
            raise ValueError(f"alpha must be in (0,1), got {alpha}")
        self.alpha = alpha
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._lg = math.log(self._gamma)
        self._clock = clock
        self._nslices = int(math.ceil(max_window_s / self.SLICE_S)) + 1
        # ring position = epoch % nslices; the stored epoch disambiguates
        # a live slice from a stale one (lazy rotation: an observe or a
        # query simply ignores/overwrites slices whose epoch is old)
        self._slices: List[Optional[Dict[int, int]]] = [None] * self._nslices
        self._epochs: List[int] = [-1] * self._nslices
        self._lock = threading.Lock()

    def _index(self, value: float) -> int:
        # bucket i covers (gamma^(i-1), gamma^i]; ceil keeps v <= gamma^i
        return int(math.ceil(math.log(max(value, _MIN_VALUE)) / self._lg))

    def _estimate(self, idx: int) -> float:
        # 2*gamma^i/(gamma+1): relative error to any value in the bucket
        # is at most (gamma-1)/(gamma+1) == alpha
        return 2.0 * (self._gamma ** idx) / (self._gamma + 1.0)

    def observe(self, value: float) -> None:
        epoch = int(self._clock() / self.SLICE_S)
        pos = epoch % self._nslices
        idx = self._index(value)
        with self._lock:
            if self._epochs[pos] != epoch:
                self._slices[pos] = {}
                self._epochs[pos] = epoch
            sl = self._slices[pos]
            sl[idx] = sl.get(idx, 0) + 1

    def _merged(self, window_s: float,
                now: Optional[float] = None) -> Dict[int, int]:
        """Bucket counts across slices younger than ``window_s`` (window
        edges quantized to one slice — ±``SLICE_S`` of slack)."""
        now = self._clock() if now is None else now
        cur_epoch = int(now / self.SLICE_S)
        min_epoch = int((now - window_s) // self.SLICE_S)
        counts: Dict[int, int] = {}
        with self._lock:
            for pos in range(self._nslices):
                e = self._epochs[pos]
                # e == -1 is a never-written slice; it must not pass the
                # staleness filter when the window reaches past t=0 of a
                # near-zero clock (injected clocks, freshly booted hosts)
                if e < max(0, min_epoch) or e > cur_epoch:
                    continue
                for idx, c in self._slices[pos].items():
                    counts[idx] = counts.get(idx, 0) + c
        return counts

    def count(self, window_s: float, now: Optional[float] = None) -> int:
        return sum(self._merged(window_s, now).values())

    def quantile(self, q: float, window_s: float,
                 now: Optional[float] = None) -> Optional[float]:
        """The q-quantile estimate over the window, or None when empty."""
        counts = self._merged(window_s, now)
        total = sum(counts.values())
        if total == 0:
            return None
        rank = max(1, int(math.ceil(q * total)))
        cum = 0
        for idx in sorted(counts):
            cum += counts[idx]
            if cum >= rank:
                return self._estimate(idx)
        return self._estimate(max(counts))  # pragma: no cover — q > 1

    def fraction_above(self, threshold: float, window_s: float,
                       now: Optional[float] = None) -> float:
        """Fraction of windowed observations strictly above the
        threshold's bucket — the latency-SLO "bad events" ratio.  Values
        in the bucket straddling the threshold count as under it
        (quantization error bounded by ``alpha``)."""
        counts = self._merged(window_s, now)
        total = sum(counts.values())
        if total == 0:
            return 0.0
        thr_idx = self._index(threshold)
        above = sum(c for idx, c in counts.items() if idx > thr_idx)
        return above / total

    def summary(self, window_s: float,
                now: Optional[float] = None) -> dict:
        counts = self._merged(window_s, now)
        total = sum(counts.values())
        if total == 0:
            return {"count": 0, "p50": None, "p95": None, "p99": None}
        ordered = sorted(counts)
        out = {"count": total}
        for label, q in (("p50", 0.5), ("p95", 0.95), ("p99", 0.99)):
            rank = max(1, int(math.ceil(q * total)))
            cum = 0
            for idx in ordered:
                cum += counts[idx]
                if cum >= rank:
                    out[label] = self._estimate(idx)
                    break
        return out


class TelemetryRecorder:
    """Ring-buffered samples of selected registry series + the hot-path
    latency digests, advanced by one daemon thread per process.

    The sampled set is fixed and small (see ``_read_all``): request and
    dispatch counters (stored cumulative, exposed as rates), failure
    counters, and the queue/session gauges the SLO engine and
    ``/debug/timeseries`` consumers actually use.  Families that are not
    registered yet (e.g. before ``bind_manager``) are skipped that tick
    and picked up once they appear.
    """

    # ring capacity: 720 samples = 1 h of history at the 5 s default
    # cadence — matches the digests' longest window
    def __init__(self, registry, interval_s: float = 5.0,
                 capacity: int = 720, alpha: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if capacity < 2:
            raise ValueError("telemetry ring needs capacity >= 2")
        self.registry = registry
        self.interval_s = float(interval_s)
        self.capacity = int(capacity)
        self._clock = clock
        self._lock = threading.Lock()
        self._rings: Dict[str, deque] = {}
        self._samples = 0
        self._sample_errors = 0
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        # extra sampled series registered by armed-only subsystems
        # (the devmem sampler): read on every tick alongside the
        # fixed SERIES set
        self._extra: List[Tuple[str, Callable[[], Optional[float]]]] = []
        # called after every sample with the sample time — the SLO
        # engine's evaluation piggybacks on the same cadence
        self.after_sample: Optional[Callable[[float], None]] = None
        # sliding-window quantile digests for the hot latency paths;
        # sites reach these through the pre-looked-up handles below
        # (one attribute load + None check when unarmed)
        self.digests: Dict[str, WindowedDigest] = {
            path: WindowedDigest(alpha=alpha, clock=clock)
            for path in ("dispatch", "http", "ticket_wait")}
        self.dispatch_digest = self.digests["dispatch"]
        self.http_digest = self.digests["http"]
        self.ticket_wait_digest = self.digests["ticket_wait"]

    # -- armed-only registry family ---------------------------------------

    def bind_metrics(self, m) -> None:
        m.counter_fn(
            "mpi_tpu_telemetry_samples_total",
            "Telemetry sampler ticks (present only when "
            "--telemetry-interval-s arms the recorder)",
            lambda: self._samples)

    # -- sampling ----------------------------------------------------------

    # (name, kind): counters are recorded cumulatively so the SLO engine
    # can take exact window deltas; /debug/timeseries renders them as
    # rates between consecutive samples
    SERIES: Tuple[Tuple[str, str], ...] = (
        ("http_requests", "counter"),
        ("http_5xx", "counter"),
        ("dispatches", "counter"),
        ("dispatch_seconds", "counter"),
        ("engine_failures", "counter"),
        ("trace_spans", "counter"),
        ("sessions", "gauge"),
        ("degraded_sessions", "gauge"),
        ("tickets_pending", "gauge"),
        ("batch_queue_depth", "gauge"),
    )
    KINDS: Dict[str, str] = dict(SERIES)

    def _read_all(self) -> Dict[str, float]:
        from mpi_tpu_torch.obs.metrics import Counter, Histogram, _FnMetric

        reg = self.registry
        out: Dict[str, float] = {}

        req = reg.get("mpi_tpu_http_requests_total")
        if isinstance(req, Counter):
            out["http_requests"] = req.total()
            out["http_5xx"] = req.total(
                where=lambda lbl: str(lbl.get("code", "")).startswith("5"))
        lat = reg.get("mpi_tpu_dispatch_latency_seconds")
        if isinstance(lat, Histogram):
            out["dispatches"] = float(lat.total_count())
            out["dispatch_seconds"] = lat.total_sum()
        for series, family in (
                ("engine_failures", "mpi_tpu_engine_failures_total"),
                ("trace_spans", "mpi_tpu_trace_spans_total"),
                ("sessions", "mpi_tpu_sessions"),
                ("degraded_sessions", "mpi_tpu_degraded_sessions"),
                ("tickets_pending", "mpi_tpu_tickets_pending"),
                ("batch_queue_depth", "mpi_tpu_batch_queue_depth")):
            fm = reg.get(family)
            if isinstance(fm, _FnMetric):
                v = fm.read_sum()
                if v is not None:
                    out[series] = v
        return out

    def add_series(self, name: str, kind: str,
                   read_fn: Callable[[], Optional[float]]) -> None:
        """Register an extra sampled series (armed-only subsystems —
        e.g. the devmem sampler's device-memory and cache-occupancy
        feeds).  ``read_fn`` returns the current value, or None to skip
        the tick.  ``KINDS`` is copied onto the instance on first use so
        the class schema stays fixed."""
        if kind not in ("counter", "gauge"):
            raise ValueError(f"series kind must be counter|gauge, "
                             f"got {kind!r}")
        if self.KINDS is type(self).KINDS:
            self.KINDS = dict(type(self).KINDS)
        self.KINDS[name] = kind
        self._extra.append((name, read_fn))

    def sample_once(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        vals = self._read_all()
        for name, fn in self._extra:
            try:
                v = fn()
            except Exception:  # noqa: BLE001 — one sick provider must
                self._sample_errors += 1  # not kill the tick
                continue
            if v is not None:
                vals[name] = float(v)
        with self._lock:
            for name, v in vals.items():
                ring = self._rings.get(name)
                if ring is None:
                    ring = self._rings[name] = deque(maxlen=self.capacity)
                ring.append((now, v))
            self._samples += 1
        cb = self.after_sample
        if cb is not None:
            cb(now)

    def window_delta(self, name: str, window_s: float,
                     now: Optional[float] = None) -> float:
        """Counter increase over the trailing window: latest sample minus
        the sample at the window start, clipped to recorded history (a
        younger-than-window process reports its whole history)."""
        with self._lock:
            ring = self._rings.get(name)
            if not ring:
                return 0.0
            now = self._clock() if now is None else now
            cutoff = now - window_s
            base = ring[0][1]
            for t, v in ring:
                if t > cutoff:
                    break
                base = v
            return max(0.0, ring[-1][1] - base)

    def series_names(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def points(self, name: str, window_s: float,
               now: Optional[float] = None) -> List[List[float]]:
        """``[[t, value], ...]`` for the trailing window — gauges raw,
        counters as the rate between consecutive samples (anchored at
        the later sample's timestamp)."""
        with self._lock:
            ring = self._rings.get(name)
            snap = list(ring) if ring else []
        if not snap:
            return []
        now = self._clock() if now is None else now
        cutoff = now - window_s
        if self.KINDS.get(name) == "gauge":
            return [[t, v] for t, v in snap if t >= cutoff]
        out: List[List[float]] = []
        prev_t, prev_v = None, None
        for t, v in snap:
            if prev_t is not None and t >= cutoff and t > prev_t:
                out.append([t, max(0.0, v - prev_v) / (t - prev_t)])
            prev_t, prev_v = t, v
        return out

    def windows_summary(self) -> dict:
        """Per-path digest summaries over every window — the `/slo`
        payload's ``windows`` block."""
        return {path: {label: dig.summary(sec)
                       for label, sec in WINDOWS}
                for path, dig in sorted(self.digests.items())}

    def stats(self) -> dict:
        with self._lock:
            return {"samples": self._samples,
                    "sample_errors": self._sample_errors,
                    "series": len(self._rings),
                    "interval_s": self.interval_s}

    # -- background cadence ------------------------------------------------

    def start(self) -> None:
        if self._thread is not None or self.interval_s <= 0:
            return
        # an immediate baseline sample: window deltas then cover all
        # traffic since arming, not since the first timer tick
        try:
            self.sample_once()
        except Exception:  # noqa: BLE001
            self._sample_errors += 1
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="mpi-tpu-telemetry", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.sample_once()
            except Exception:  # noqa: BLE001 — the sampler must outlive
                self._sample_errors += 1  # one sick provider/objective

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join(timeout=5.0)
        self._thread = None
        self._stop = None
