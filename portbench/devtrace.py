"""The traced run: ``torch.profiler`` around the measured window, and its
reduction to what the per-layer readers read.

The harness marks its own calls into the program with spans
(``record_function``) named in :data:`SPANS`; the window is the span
``window``.  From the profiler's raw records (``kineto_results``, which
skips the slow tree that ``events()`` builds):

* device operations: every kernel, copy and set the card ran, clipped to
  the window, by name (count, seconds);
* busy seconds: the union of their intervals in the window;
* idle gaps: every stretch of the window with no device operation, named
  by what the host was doing when it began (the innermost harness span
  then open, and the innermost operation on the host), summed by name.

Kernel names are the program's: K1 ``bit_step_kernel``, K2
``dense_step_kernel`` and its narrow instance, K3 ``ltl_step_kernel``.
"""

from __future__ import annotations

import bisect
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

KERNEL_NAMES = {"K1": ("bit_step_kernel",),
                "K2": ("dense_step_kernel", "dense_narrow_kernel"),
                "K3": ("ltl_step_kernel",)}

# the harness's spans around its calls into the program
SPANS = ("window", "engine.step", "client.step", "check.copy")

# a gap's name is looked for among at most this many host records that
# began before it
_LOOKBACK = 4096


@dataclass
class Trace:
    """What one traced window shows."""

    window_s: float
    busy_s: float
    ops: Dict[str, Tuple[int, float]] = field(default_factory=dict)
    gaps: Dict[str, float] = field(default_factory=dict)

    def kernel(self, kid: str) -> Tuple[int, float]:
        """(records, device seconds) of kernel ``kid`` (K1, K2 or K3)."""
        names = KERNEL_NAMES[kid]
        n = s = 0
        for name, (c, t) in self.ops.items():
            if any(k in name for k in names):
                n, s = n + c, s + t
        return n, s

    def device_seconds(self) -> float:
        """Device seconds of every operation, overlaps counted twice."""
        return sum(t for _, t in self.ops.values())

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(((n, t) for n, (_, t) in self.ops.items()),
                     key=lambda x: -x[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[n, t] for n, t in ops],
                "idle_gaps": [[n, t] for n, t in gaps]}


class Capture:
    """The profiler over a run's window when ``enabled`` (spans are free
    otherwise), on the CPU and, where there is one, the card."""

    def __init__(self, enabled: bool, cuda: bool):
        self.enabled = enabled
        self.cuda = cuda
        self.prof = None

    def span(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(name)

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.cuda:
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)
        return False

    def reduce(self) -> Optional[Trace]:
        """The window's :class:`Trace` (None when not enabled)."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType

        host, device = [], []
        for e in self.prof.profiler.kineto_results.events():
            rec = (e.start_ns(), e.end_ns(), e.name())
            if e.device_type() == DeviceType.CPU:
                host.append(rec)
            elif e.device_type() == DeviceType.CUDA \
                    and not e.is_user_annotation() and e.name() not in SPANS:
                device.append(rec)
        return reduce_records(host, device)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _innermost(records, starts, t: int) -> Optional[str]:
    """The latest-begun record of ``records`` (sorted by start) that is
    open at ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(-1, i - _LOOKBACK), -1):
        s, e, name = records[j]
        if e >= t:
            return name
    return None


def reduce_records(host, device) -> Trace:
    """A :class:`Trace` from host records and device records, each
    ``(start_ns, end_ns, name)``: the window is the host span ``window``."""
    windows = [(s, e) for s, e, n in host if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    ws, we = windows[0]
    ops: Dict[str, Tuple[int, float]] = {}
    inside = []
    for s, e, name in device:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        inside.append((s, e))
        c, t = ops.get(name, (0, 0.0))
        ops[name] = (c + 1, t + (e - s) / 1e9)
    busy = _union(inside)
    busy_ns = sum(e - s for s, e in busy)
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    host = sorted(r for r in host if r[2] != "window")
    spans = [r for r in host if r[2] in SPANS]
    host_starts = [r[0] for r in host]
    span_starts = [r[0] for r in spans]
    gaps: Dict[str, float] = {}
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        span = _innermost(spans, span_starts, gs) or "window"
        op = _innermost(host, host_starts, gs)
        name = span if op in (None, span) else f"{span}:{op}"
        gaps[name] = gaps.get(name, 0.0) + (ge - gs) / 1e9
    return Trace(window_s=(we - ws) / 1e9, busy_s=busy_ns / 1e9, ops=ops,
                 gaps=gaps)
