"""Counters, gauges, and fixed-bucket histograms with a Prometheus
text-format renderer — the serve stack's metrics channel.

Stdlib-only and deliberately tiny: the serving stack needs exactly three
instrument kinds (the ones every production inference server is tuned
off — Orca-style occupancy/latency histograms, breaker/cache gauges,
dispatch counters), not a client-library dependency.  All mutation goes
through one registry lock; ``observe``/``inc`` are a dict lookup plus an
integer bump (~1 µs), cheap enough for the step hot path, and rendering
walks the registry only at scrape time (``GET /metrics``).

Two callback flavors (``gauge_fn``/``counter_fn``) evaluate at scrape
time instead of being pushed: values that already live somewhere
authoritative (engine compile counters, breaker states, queue depth)
must not be shadow-counted — double bookkeeping is how metrics drift
from the truth they claim to report.  Registration is idempotent by
name so re-binding a manager to a registry never raises.

Histogram buckets are FIXED at creation (cumulative ``le`` semantics,
``+Inf`` implied): fixed buckets make ``observe`` O(log n_buckets) with
zero allocation, and bucket counts are monotone by construction — the
property ``tests/test_obs.py`` asserts on the rendered text.

Histograms additionally keep the last trace context seen per bucket as
an OpenMetrics *exemplar* (``# {trace_id="..."} value timestamp`` after
the ``_bucket`` sample).  Exemplars are rendered ONLY when the scraper
negotiates ``Accept: application/openmetrics-text`` — the default
Prometheus text stays byte-identical whether or not any were captured,
and capture itself costs one ``ContextVar`` read (a no-op store when
the observe happens outside a traced request).
"""

from __future__ import annotations

import bisect
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from mpi_tpu_torch.obs.tracectx import current_trace_context

# Dispatch/request latencies: 0.5 ms (CPU dispatch floor) up to 10 s
# (a watchdogged hang), finest in the millisecond range where a served
# step's launch and wait sit.
LATENCY_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)
# Batch occupancy B: bounded by batch_max (default 8), headroom to 32.
OCCUPANCY_BUCKETS = (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0, 16.0, 24.0, 32.0)
# Build and warm-up wall: milliseconds for a warm-up of a loaded kernel
# to minutes for a first nvcc build of many rules.
COMPILE_BUCKETS = (0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
                   30.0, 60.0, 120.0)
# Checkpoint/restore file+replay work: sub-ms JSON rewrites to
# multi-second replays.
IO_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
              0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)


def _fmt(v: float) -> str:
    """Prometheus sample value: integers render bare, floats minimally."""
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace('"', r"\"")
            .replace("\n", r"\n"))


def _labels_str(labels: Tuple[Tuple[str, str], ...]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _exemplar_str(ex: Optional[tuple]) -> str:
    """OpenMetrics exemplar suffix for a ``_bucket`` sample: the last
    traced observation that landed in the bucket, or nothing."""
    if ex is None:
        return ""
    trace_id, value, ts = ex
    return (f' # {{trace_id="{_escape(trace_id)}"}} '
            f"{_fmt(value)} {ts:.3f}")


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str, lock: threading.Lock):
        self.name = name
        self.help = help_
        self._lock = lock
        # registry-wide constant labels (cluster mode's host/process),
        # prepended to every rendered sample; () renders nothing — the
        # single-process text format is byte-identical
        self.const: Tuple[Tuple[str, str], ...] = ()

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.kind}"]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, lock):
        super().__init__(name, help_, lock)
        self._vals: Dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _key(labels)
        with self._lock:
            self._vals[k] = self._vals.get(k, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._vals.get(_key(labels), 0.0)

    def total(self, where: Optional[Callable[[dict], bool]] = None) -> float:
        """Sum across label sets, optionally filtered by a predicate over
        the labels dict — the telemetry sampler's counter readout."""
        with self._lock:
            if where is None:
                return sum(self._vals.values())
            return sum(v for k, v in self._vals.items() if where(dict(k)))

    def render(self) -> List[str]:
        out = self._header()
        with self._lock:
            items = sorted(self._vals.items())
        for k, v in items:
            out.append(f"{self.name}{_labels_str(self.const + k)} {_fmt(v)}")
        if not items:
            out.append(f"{self.name}{_labels_str(self.const)} 0")
        return out


class Gauge(Counter):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._vals[_key(labels)] = float(value)


class _FnMetric(_Metric):
    """Scrape-time callback metric.  ``fn`` returns a number or a list of
    ``(labels_dict, value)`` pairs; a raising callback renders nothing —
    a scrape must never 500 because one provider hiccuped."""

    def __init__(self, name, help_, lock, fn: Callable, kind: str):
        super().__init__(name, help_, lock)
        self._fn = fn
        self.kind = kind

    def read_sum(self) -> Optional[float]:
        """Evaluate the callback now and collapse it to one number (label
        sets summed); ``None`` when the provider raises — same tolerance
        as ``render``.  Used by the telemetry sampler, never by scrapes."""
        try:
            val = self._fn()
        except Exception:  # noqa: BLE001 — same contract as render()
            return None
        if isinstance(val, (int, float)):
            return float(val)
        try:
            return float(sum(v for _, v in val))
        except Exception:  # noqa: BLE001
            return None

    def render(self) -> List[str]:
        try:
            val = self._fn()
        except Exception:  # noqa: BLE001 — scrape survives a sick provider
            return []
        out = self._header()
        if isinstance(val, (int, float)):
            out.append(f"{self.name}{_labels_str(self.const)} "
                       f"{_fmt(float(val))}")
        else:
            for labels, v in val:
                out.append(
                    f"{self.name}{_labels_str(self.const + _key(labels))} "
                    f"{_fmt(float(v))}")
        return out


class _BoundSeries:
    """A histogram series pre-resolved to its label set — the hot-path
    handle.  ``observe`` skips the per-call kwargs dict and label-key
    sort (the expensive half of a labeled observe), leaving lock +
    bisect + three increments (~0.6 µs)."""

    __slots__ = ("_lock", "_buckets", "_st")

    def __init__(self, lock, buckets, st):
        self._lock = lock
        self._buckets = buckets
        self._st = st

    def observe(self, value: float) -> None:
        ctx = current_trace_context()
        with self._lock:
            st = self._st
            i = bisect.bisect_left(self._buckets, value)
            st[0][i] += 1
            st[1] += value
            st[2] += 1
            if ctx is not None:
                st[3][i] = (ctx.trace_id, value, time.time())


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, lock, buckets):
        super().__init__(name, help_, lock)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError("histogram needs at least one bucket bound")
        self.buckets = bs
        # label-key -> [per-bucket counts (+1 overflow slot), sum, count,
        #               per-bucket last exemplar (trace_id, value, t) | None]
        self._series: Dict[tuple, list] = {}

    def _new_st(self) -> list:
        n = len(self.buckets) + 1
        return [[0] * n, 0.0, 0, [None] * n]

    def series(self, **labels) -> _BoundSeries:
        """The pre-bound handle for ``labels`` (created empty if new) —
        bind once at wiring time, observe cheaply per step."""
        k = _key(labels)
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = self._new_st()
        return _BoundSeries(self._lock, self.buckets, st)

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        ctx = current_trace_context()
        with self._lock:
            st = self._series.get(k)
            if st is None:
                st = self._series[k] = self._new_st()
            # le semantics: first bound with value <= bound
            i = bisect.bisect_left(self.buckets, value)
            st[0][i] += 1
            st[1] += value
            st[2] += 1
            if ctx is not None:
                st[3][i] = (ctx.trace_id, value, time.time())

    def count(self, **labels) -> int:
        with self._lock:
            st = self._series.get(_key(labels))
            return st[2] if st else 0

    def total_count(self) -> int:
        """Observations across every label set — the sampler's "how many
        dispatches happened" readout."""
        with self._lock:
            return sum(st[2] for st in self._series.values())

    def total_sum(self) -> float:
        """Summed observed values across every label set."""
        with self._lock:
            return float(sum(st[1] for st in self._series.values()))

    def render(self, exemplars: bool = False) -> List[str]:
        out = self._header()
        with self._lock:
            items = [(k, (list(st[0]), st[1], st[2], list(st[3])))
                     for k, st in sorted(self._series.items())]
        for k, (counts, total, n, exs) in items:
            ck = self.const + k
            cum = 0
            for i, (bound, c) in enumerate(zip(self.buckets, counts)):
                cum += c
                labels = ck + (("le", "%g" % bound),)
                out.append(f"{self.name}_bucket{_labels_str(labels)} {cum}"
                           f"{_exemplar_str(exs[i]) if exemplars else ''}")
            cum += counts[-1]
            out.append(
                f"{self.name}_bucket{_labels_str(ck + (('le', '+Inf'),))} "
                f"{cum}"
                f"{_exemplar_str(exs[-1]) if exemplars else ''}")
            out.append(f"{self.name}_sum{_labels_str(ck)} {_fmt(total)}")
            out.append(f"{self.name}_count{_labels_str(ck)} {n}")
        return out


class MetricsRegistry:
    """Named instruments + the text renderer behind ``GET /metrics``.

    One lock serves every instrument: contention is negligible (scrapes
    are rare, mutations are sub-µs) and a single lock cannot deadlock.
    Re-registering a name returns the existing instrument when the kind
    matches (idempotent binding) and replaces it otherwise.
    """

    def __init__(self, const_labels: Optional[dict] = None):
        self._lock = threading.Lock()
        self._metrics: Dict[str, _Metric] = {}
        self._const: Tuple[Tuple[str, str], ...] = _key(const_labels or {})

    def set_const_labels(self, labels: Optional[dict]) -> None:
        """(Re)set the constant labels stamped on every rendered sample
        — cluster mode sets ``host``/``process`` here after the serving
        socket binds.  Single-process serving never calls this, keeping
        the text format byte-identical to the non-cluster build."""
        const = _key(labels or {})
        with self._lock:
            self._const = const
            for m in self._metrics.values():
                m.const = const

    def _register(self, cls, name, help_, *args):
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None and type(existing) is cls \
                    and not issubclass(cls, _FnMetric):
                return existing
        m = cls(name, help_, self._lock, *args)
        with self._lock:
            m.const = self._const
            self._metrics[name] = m
        return m

    def counter(self, name: str, help_: str) -> Counter:
        return self._register(Counter, name, help_)

    def gauge(self, name: str, help_: str) -> Gauge:
        return self._register(Gauge, name, help_)

    def histogram(self, name: str, help_: str,
                  buckets=LATENCY_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help_, buckets)

    def gauge_fn(self, name: str, help_: str, fn: Callable) -> None:
        self._register(_FnMetric, name, help_, fn, "gauge")

    def counter_fn(self, name: str, help_: str, fn: Callable) -> None:
        self._register(_FnMetric, name, help_, fn, "counter")

    def get(self, name: str) -> Optional[_Metric]:
        with self._lock:
            return self._metrics.get(name)

    def render(self, openmetrics: bool = False) -> str:
        """Prometheus text exposition; ``openmetrics=True`` is the
        negotiated variant that appends histogram exemplars and the
        ``# EOF`` terminator.  The default render path is untouched by
        exemplar capture — byte-identical to pre-exemplar builds."""
        with self._lock:
            metrics = [self._metrics[n] for n in sorted(self._metrics)]
        lines: List[str] = []
        for m in metrics:
            if openmetrics and isinstance(m, Histogram):
                lines.extend(m.render(exemplars=True))
            else:
                lines.extend(m.render())
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"
