"""The program's own spans in a traced window: what the device ran, and
where it stood idle, charged to the span of the program that launched it.

The program (``mpi_tpu_torch``) opens a ``torch.profiler.record_function``
range for each span of an armed ``Obs`` handle while the profiler
records (``obs/trace.py``): ``engine.pass`` around each pass of a
one-device engine, and inside it ``seam.extract``, ``seam.band`` and
``seam.stitch`` around the seam band of a periodic padded grid.  From the
profiler's raw records:

* spans: each program span that began in the window, by name (count);
* launches and device seconds: each device operation in the window
  (clipped to it, as :func:`portbench.devtrace.reduce_records` clips
  them) is joined by its correlation id to the runtime call on the host
  that launched it (``cudaLaunchKernel``, ``cudaMemcpyAsync``, ...), and
  charged to the innermost program span open around that call;
* idle: each gap of the window in which the card ran nothing is charged
  to the operation that ends it, and so to that operation's span.  It is
  *late* when the launching call returned after the gap began (the host
  was late with the launch) and a *bubble* when it returned before (the
  operation was queued and the card still waited).

Operations launched outside every program span are charged to
:data:`NO_SPAN`; gaps that no operation ends (the window's tail) to
:data:`WINDOW_END`.

The benchmark's traced run does not arm the program's spans, so its
result line carries none of this: that needs ``kinds/run.py`` to give the
engine an ``Obs()`` before ``warm_up`` in a traced run, and
``devtrace.py`` to keep the runtime calls and the correlation ids that
:func:`records` reads.  Until then this module's ``main`` measures a cell
with the spans armed:

    python3 -m portbench.progspans --workload life.padded --seed N \\
        --seconds S [--spans 0|1]

prints one JSON line: the cell's per-layer metrics as the benchmark reads
them in the same traced window, ``idle_share`` and the device breakdown
among them, the program's spans (:func:`reduce_spans`), the seam band's
three readings (:func:`seam_readings`) and the kernel libraries'
counters (``ops/_build.py``: ``builds``, ``loads``, ``load_seconds``).
"""

from __future__ import annotations

import bisect
import contextlib
from typing import Dict, List, Optional, Tuple

from portbench.devtrace import SPANS

# the program's spans on the engine's path
PROGRAM_SPANS = ("engine.pass", "seam.extract", "seam.band", "seam.stitch")
SEAM_SPANS = ("seam.extract", "seam.band", "seam.stitch")
NO_SPAN = "(no span)"
WINDOW_END = "(window end)"

Record = Tuple[int, int, str]

# a call's span is looked for among at most this many spans that began
# before it (spans nest a few deep)
_LOOKBACK = 64


def records(prof) -> Tuple[List[Record], List[Tuple[int, int, int]],
                           List[Tuple[int, int, str, int]]]:
    """(host, runtime, device) records of a ``torch.profiler.profile``
    that has stopped: every host record ``(start_ns, end_ns, name)`` (as
    ``devtrace.Capture.reduce`` passes them on), the runtime calls that
    launch work on the card ``(start_ns, end_ns, correlation id)``, and
    the device operations ``(start_ns, end_ns, name, correlation id)``
    (those ``devtrace`` leaves out left out here too)."""
    from torch.autograd import DeviceType

    host, runtime, device = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CPU:
            host.append((e.start_ns(), e.end_ns(), e.name()))
            if e.name().startswith("cu") and not e.is_user_annotation():
                runtime.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif e.device_type() == DeviceType.CUDA \
                and not e.is_user_annotation() and e.name() not in SPANS:
            device.append((e.start_ns(), e.end_ns(), e.name(),
                           e.correlation_id()))
    return host, runtime, device


def _innermost(spans: List[Record], starts: List[int], s: int,
               e: int) -> Optional[str]:
    """The latest-begun span of ``spans`` (sorted by start) that holds the
    interval [s, e]."""
    i = bisect.bisect_right(starts, s) - 1
    for j in range(i, max(-1, i - _LOOKBACK), -1):
        _, se, name = spans[j]
        if se >= e:
            return name
    return None


def reduce_spans(host: List[Record], runtime, device,
                 names=PROGRAM_SPANS) -> dict:
    """The window's device work and idle time by program span.

    ``host``, ``runtime`` and ``device`` as :func:`records` gives them;
    the window is the host record ``window``.  Returns ``{"window_s",
    "device_s", "idle_s", "spans": {name: {"count", "launches",
    "device_s", "idle_late_s", "idle_bubble_s"}}}``, with rows for
    :data:`NO_SPAN` and :data:`WINDOW_END` where anything falls there."""
    windows = [(s, e) for s, e, n in host if n == "window"]
    if len(windows) != 1:
        raise RuntimeError(f"the trace holds {len(windows)} window spans")
    ws, we = windows[0]
    spans = sorted(r for r in host if r[2] in names)
    starts = [r[0] for r in spans]
    calls = {c: (s, e) for s, e, c in runtime}
    rows: Dict[str, dict] = {}

    def row(name):
        return rows.setdefault(name, {"count": 0, "launches": 0,
                                      "device_s": 0.0, "idle_late_s": 0.0,
                                      "idle_bubble_s": 0.0})

    for s, _, name in spans:
        if ws <= s < we:
            row(name)["count"] += 1
    ops = []  # (start, end, span, the launching call's end)
    for s, e, _, corr in device:
        s, e = max(s, ws), min(e, we)
        if e <= s:
            continue
        call = calls.get(corr)
        span = None if call is None else _innermost(spans, starts, *call)
        span = span or NO_SPAN
        ops.append((s, e, span, None if call is None else call[1]))
        r = row(span)
        r["launches"] += 1
        r["device_s"] += (e - s) / 1e9
    ops.sort()
    device_ns = sum(e - s for s, e, _, _ in ops)
    idle_ns, busy_end = 0, ws
    for s, e, span, returned in ops:
        if s > busy_end:
            gap = s - busy_end
            idle_ns += gap
            late = returned is None or returned > busy_end
            row(span)["idle_late_s" if late else "idle_bubble_s"] += gap / 1e9
        busy_end = max(busy_end, e)
    if we > busy_end:
        idle_ns += we - busy_end
        row(WINDOW_END)["idle_late_s"] += (we - busy_end) / 1e9
    return {"window_s": (we - ws) / 1e9, "device_s": device_ns / 1e9,
            "idle_s": idle_ns / 1e9, "spans": rows}


def seam_readings(reduced: dict) -> dict:
    """The seam band's three readings of :func:`reduce_spans`'s result:
    ``seam_band_share`` (% of device seconds launched inside ``seam.*``),
    ``seam_launches_per_pass`` (their launches over the ``engine.pass``
    spans) and ``seam_idle_share`` (% of the window idle before an
    operation launched inside ``seam.*``); empty without a seam span."""
    rows = reduced["spans"]
    seam = [rows[n] for n in SEAM_SPANS if n in rows]
    passes = rows.get("engine.pass", {}).get("count", 0)
    if not seam or not passes or reduced["device_s"] <= 0:
        return {}
    return {
        "seam_band_share": 100 * sum(r["device_s"] for r in seam)
        / reduced["device_s"],
        "seam_launches_per_pass": sum(r["launches"] for r in seam) / passes,
        "seam_idle_share": 100 * sum(r["idle_late_s"] + r["idle_bubble_s"]
                                     for r in seam) / reduced["window_s"],
    }


@contextlib.contextmanager
def armed_engines():
    """Every engine ``build_engine`` makes inside the block carries an
    ``Obs()`` from the start, so its spans record."""
    from mpi_tpu_torch.backends import cuda
    from mpi_tpu_torch.obs import Obs

    build = cuda.build_engine

    def build_armed(*args, **kw):
        engine = build(*args, **kw)
        engine.obs = Obs()
        return engine

    cuda.build_engine = build_armed
    try:
        yield
    finally:
        cuda.build_engine = build


def measure(name: str, seed: int, seconds: float, spans: bool,
            t0: float, device: str = "cuda",
            traffic: Optional[dict] = None) -> dict:
    """One traced run of cell ``name``, the program's spans armed when
    ``spans``: the benchmark's per-layer metrics of the cell and its
    breakdown, ``correct``, the program's spans and the seam band's
    readings, and the kernel libraries' counters."""
    import importlib
    import sys

    from portbench import harness, roofline
    from portbench.devtrace import Capture, reduce_records
    from portbench.reference.cells import parse_rule

    manifest = harness.load_manifest()
    cell = harness.cell_entry(manifest, name)
    config = harness.config_file(manifest, cell["config"])
    traffic = traffic or harness.traffic_file(cell["traffic"])
    cuda = device == "cuda"
    ctx = harness.Context(config=config, traffic=traffic,
                          rule=parse_rule(config["rule"]), seed=seed,
                          seconds=seconds, device=device, t0=t0,
                          capture=Capture(True, cuda), marks={})
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    with armed_engines() if spans else contextlib.nullcontext():
        out = kind.run(ctx)
    host, runtime, device_recs = records(ctx.capture.prof)
    trace = reduce_records(host, [r[:3] for r in device_recs])
    work = dict(out.work)
    if cuda:
        work["int32_ops_per_s"] = roofline.int32_ops_per_s()
        work["hbm_bytes_per_s"] = roofline.HBM_BYTES_PER_S
    metrics = {}
    for m in harness.per_layer(manifest, name):
        v = harness.reader(m["name"])(trace, work)
        if v is not None:
            metrics[m["name"]] = v
    reduced = reduce_spans(host, runtime, device_recs)
    build = sys.modules.get("mpi_tpu_torch.ops._build")
    return {"workload": name, "seed": seed, "spans_armed": spans,
            "correct": all(v <= lim for _, v, lim in out.checks),
            "cell_updates_per_s": out.e2e["cell_updates_per_s"],
            "metrics": metrics, "breakdown": trace.breakdown(),
            "program_spans": reduced, "seam": seam_readings(reduced),
            "kernels": {k: getattr(build, k, None)
                        for k in ("builds", "loads", "load_seconds")}}


def main(argv=None) -> int:
    import argparse
    import json
    import time

    t0 = time.perf_counter()
    p = argparse.ArgumentParser(prog="python3 -m portbench.progspans",
                                description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    print(json.dumps(measure(args.workload, args.seed, args.seconds,
                             bool(args.spans), t0)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
