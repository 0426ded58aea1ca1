"""Profiling hooks: on-demand device traces over live traffic and a
compile-vs-execute breakdown from counters the engine already keeps.

``run_profile`` captures ``secs`` of whatever the serve loop is doing
*right now* with ``torch.profiler`` (CPU and CUDA activity) and writes a
Chrome trace into ``logdir``, without restarting anything.  One capture at
a time: the profiler is process-global, so a second concurrent request is
refused rather than corrupting the first capture.

``compile_execute_breakdown`` answers the triage question: is this
deployment build-bound (kernel builds and warm-ups dominate),
dispatch-bound (each step's fixed cost, the host's launches and the wait
for the device, dominates — batching would help), or compute-bound (the
device is actually busy)?  It is derived entirely from counters the
engine and batcher already maintain (``compile_count``/``step_calls``/
``batched_step_calls``/``compile_wall_s`` and the batcher's amortization
stats) — no new instrumentation on the hot path.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List

_profile_lock = threading.Lock()
# set while a capture records: the window a caller can hold its own counts
# against (the profiler's own on-flag is per thread)
capturing = threading.Event()


def run_profile(logdir: str, secs: float) -> Dict:
    """Capture ``secs`` of CPU and device trace into ``logdir`` as one
    Chrome trace (``trace-<pid>-<ns>.json``).  Returns a JSON-ready dict
    with the trace's ``path``; a capture already in flight answers
    ``ok: False`` (the profiler is process-global — two captures would
    corrupt each other)."""
    secs = max(0.05, min(float(secs), 120.0))
    if not _profile_lock.acquire(blocking=False):
        return {"ok": False, "error": "a profile capture is already running"}
    try:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        os.makedirs(logdir, exist_ok=True)
        path = os.path.join(logdir,
                            f"trace-{os.getpid()}-{time.time_ns()}.json")
        with profile(activities=activities) as prof:
            capturing.set()
            try:
                time.sleep(secs)
            finally:
                capturing.clear()
        prof.export_chrome_trace(path)
        return {"ok": True, "log_dir": logdir, "seconds": secs,
                "path": path}
    except Exception as e:  # noqa: BLE001 — profiling must not fail serving
        return {"ok": False, "log_dir": logdir,
                "error": f"{type(e).__name__}: {e}"}
    finally:
        _profile_lock.release()


def _live_engines(manager) -> List:
    """Every distinct engine the manager can reach: the cache's entries
    plus any engine a live session still holds after eviction (sessions
    keep their own reference — cache.py's eviction contract)."""
    seen, out = set(), []
    for eng in manager.cache.engines():
        if id(eng) not in seen:
            seen.add(id(eng))
            out.append(eng)
    with manager._lock:
        sessions = list(manager._sessions.values())
    for s in sessions:
        eng = s.engine
        if eng is not None and id(eng) not in seen:
            seen.add(id(eng))
            out.append(eng)
    return out


def compile_execute_breakdown(manager) -> Dict:
    """Aggregate compile vs execute time over every reachable engine and
    name the regime.  'compile-bound': build and warm-up wall exceeds
    execute wall (cold start, signature churn).  'dispatch-bound':
    batching is amortizing a large fixed per-call cost (or would — solo
    per-call time dwarfs the batched per-board time).  'compute-bound':
    neither — the device is doing real work."""
    engines = _live_engines(manager)
    compiles = sum(e.compile_count for e in engines)
    batched_compiles = sum(e.batched_compile_count for e in engines)
    step_calls = sum(e.step_calls for e in engines)
    batched_calls = sum(e.batched_step_calls for e in engines)
    compile_wall = sum(getattr(e, "compile_wall_s", 0.0) for e in engines)
    if manager.batcher is not None:
        bs = manager.batcher.stats()
        execute_wall = bs["batched_step_s"] + bs["solo_step_s"]
        solo_steps = bs["solo_steps"]
        amortized = bs["amortized_board_step_s"]
        solo_avg = (bs["solo_step_s"] / solo_steps) if solo_steps else None
    else:
        with manager._lock:
            sessions = list(manager._sessions.values())
        execute_wall = sum(s.steady_s for s in sessions)
        amortized = None
        solo_avg = (execute_wall / step_calls) if step_calls else None
    if compiles == 0 and step_calls == 0 and batched_calls == 0:
        regime = "idle"
    elif compile_wall > execute_wall:
        regime = "compile-bound"
    elif (amortized is not None and solo_avg
          and 1.0 - amortized / solo_avg > 0.5):
        # batching recovers >50% of the per-call cost: the fixed
        # dispatch overhead, not the compute, was the bill
        regime = "dispatch-bound"
    else:
        regime = "compute-bound"
    return {
        "engines": len(engines),
        "compiles": compiles,
        "batched_compiles": batched_compiles,
        "compile_wall_s": round(compile_wall, 6),
        "step_calls": step_calls,
        "batched_step_calls": batched_calls,
        "execute_wall_s": round(execute_wall, 6),
        "solo_avg_call_s": round(solo_avg, 6) if solo_avg else None,
        "amortized_board_step_s": amortized,
        "regime": regime,
    }
