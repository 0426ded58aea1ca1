"""Per-dispatch flight recorder.

Every device dispatch the serve stack commits — solo, batched, depth-1
unit round, host fallback — leaves one bounded *flight record*: which
plan signature ran, which engine kind took it (dense / fused / sparse /
seam), how the k-generation segment schedule decomposed the request,
how many boards rode the batch, which sparse rung fired and over how
many active tiles, whether the input buffer was donated, and where the
wall time went (``setup_s`` = ensure-compiled + stacking, ``device_s``
= dispatch wall including the sync, ``block_s`` = the
``block_until_ready`` tail alone).  Records carry the request id and
distributed-trace linkage of the dispatch that produced them, so a slow
``/debug/flights`` row joins back to its trace with no guesswork.

The ring reuses the tracer's "lock-free-ish" discipline (``trace.py``):
slot indices from ``itertools.count()`` (atomic ``__next__`` in
CPython), each record one slot store of an immutable-by-convention
dict, a (mono, unix) anchor pair so wall-clock conversion happens at
export time only.  A full turn of the ring emits one ``flight_drop``
trace event — the trace stream says "history was lost here" without
per-record overhead.

Armed-only (``Obs.arm_flight``): the
unarmed scrape text, trace JSONL, and every served payload stay
byte-identical to the pre-flight build.
"""

from __future__ import annotations

import itertools
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from mpi_tpu_torch.obs.tracectx import TRACE_CONTEXT
from mpi_tpu_torch.obs.trace import REQUEST_ID

__all__ = ["FlightRecorder", "engine_kind"]


def engine_kind(engine) -> str:
    """Classify a live engine the way PERF.md talks about it: ``sparse``
    (dirty-tile plan armed), ``seam`` (periodic pad with the seam band),
    ``fused`` (a k-generation CUDA kernel, K1, K2 or K3, launched on the
    card), else ``dense`` (the kernel's plain version, off the card).
    Sparse wins ties — the rung decides what runs."""
    if getattr(engine, "sparse_plan", None) is not None:
        return "sparse"
    if (getattr(engine, "pad_bits", 0) > 0
            and getattr(engine.config, "boundary", None) == "periodic"):
        return "seam"
    if getattr(getattr(engine, "device", None), "type", None) == "cuda":
        return "fused"
    return "dense"


class FlightRecorder:
    """Bounded ring of per-dispatch flight records.

    ``record`` is called inside the dispatch sites' existing
    ``obs is not None`` blocks, AFTER the timings are taken — it adds
    one dict build and one slot store to the armed path and nothing to
    the unarmed one.  ``on_record`` (the anomaly detector's feed) is
    invoked outside any lock with ``(signature, device_s, trace_id)``.
    """

    def __init__(self, capacity: int = 1024, obs=None):
        if capacity < 1:
            raise ValueError("flight ring capacity must be >= 1")
        self.capacity = int(capacity)
        self._obs = obs
        self._buf: List[Optional[Dict[str, Any]]] = [None] * self.capacity
        self._seq = itertools.count()
        # export-time wall-clock anchor, same scheme as Tracer
        self._anchor_mono = time.perf_counter()
        self._anchor_unix = time.time()
        self.on_record: Optional[Callable[[Optional[str], float,
                                           Optional[str]], None]] = None

    # -- recording -------------------------------------------------------

    def record(self, mode: str, *, engine=None, steps: int = 0,
               session: Optional[str] = None,
               sessions: Optional[List[str]] = None,
               batch: Optional[int] = None,
               setup_s: float = 0.0, device_s: float = 0.0,
               block_s: float = 0.0, sparse: Optional[dict] = None,
               rid: Optional[int] = None,
               links: Optional[List[str]] = None,
               request_ids: Optional[List] = None,
               window: Optional[Tuple[int, int, int, int]] = None,
               shards_touched: Optional[int] = None) -> Dict[str, Any]:
        """Record one committed dispatch.  ``engine`` is the live engine
        the dispatch ran on — signature, kind, donation, tuning, mesh
        shape, and the k-segment composition are derived here so the
        call sites stay one line.  ``sparse`` is the ``sparse_stats``
        dict the session path already computed (never recomputed — a
        donated grid may be gone by now).  ``window`` (an ``x0, y0, h,
        w`` viewport) and ``shards_touched`` attribute O(viewport)
        reads: which board slice was served and how many device shards
        it cost.  ``kernel`` names the engine's kernel (K1, K2, K3) and
        ``k`` its generations per launch."""
        steps = int(steps)
        rec: Dict[str, Any] = {
            "mode": mode,
            "steps": steps,
            "setup_s": round(setup_s, 9),
            "device_s": round(device_s, 9),
            "block_s": round(block_s, 9),
        }
        if session is not None:
            rec["session"] = session
        if sessions is not None:
            rec["sessions"] = list(sessions)
        if batch is not None:
            rec["batch"] = int(batch)
        sig = None
        if engine is not None:
            sig = getattr(engine, "sig_label", None)
            rec["signature"] = sig
            rec["engine"] = engine_kind(engine)
            rec["donated"] = bool(getattr(engine, "donates_input", False))
            rec["tuned"] = getattr(engine, "tuned_plan", None) is not None
            rec["bitpacked"] = bool(getattr(engine, "bitpacked", False))
            kernel = getattr(engine, "kernel_id", None)
            if kernel is not None:
                rec["kernel"] = kernel
            k = int(getattr(engine, "depth", None)
                    or getattr(engine.config, "comm_every", 1) or 1)
            rec["k"] = k
            if steps:
                rec["segments"] = {"full": steps // k, "rem": steps % k}
            mi = getattr(engine, "mi", None)
            mj = getattr(engine, "mj", None)
            if mi and mj:
                rec["mesh"] = f"{mi}x{mj}"
        else:
            rec["engine"] = "host"
        if window is not None:
            x0, y0, h, w = window
            rec["window"] = {"x0": int(x0), "y0": int(y0),
                             "h": int(h), "w": int(w)}
        if shards_touched is not None:
            rec["shards"] = int(shards_touched)
        if sparse is not None:
            rec["sparse"] = {
                "active_tiles": sparse.get("active_tiles"),
                "active_fraction": sparse.get("active_fraction"),
                "rung": sparse.get("mode"),
            }
        if rid is None:
            rid = REQUEST_ID.get()
        if rid is not None:
            rec["rid"] = rid
        ctx = TRACE_CONTEXT.get()
        trace_id = None
        if ctx is not None:
            trace_id = ctx.trace_id
            rec["trace_id"] = trace_id
            rec["span_id"] = ctx.span_id
        if links:
            rec["links"] = list(links)
        if request_ids:
            rec["request_ids"] = list(request_ids)
        i = next(self._seq)
        rec["seq"] = i
        rec["t_mono"] = time.perf_counter()
        self._buf[i % self.capacity] = rec
        # one drop marker per full turn of the ring, not per overwrite:
        # the trace stream records that flight history was lost without
        # the hot path paying for an event per dispatch
        if i and i % self.capacity == 0 and self._obs is not None:
            self._obs.event("flight_drop", dropped=self.capacity, total=i)
        cb = self.on_record
        # zero-step records (viewport reads) never feed the anomaly
        # baseline — it models dispatch latency, not transfer wall
        if cb is not None and steps:
            cb(sig, device_s, trace_id)
        return rec

    # -- export ----------------------------------------------------------

    def _to_dict(self, rec: Dict[str, Any]) -> Dict[str, Any]:
        d = dict(rec)
        t0 = d.pop("t_mono")
        d["t_unix"] = round(self._anchor_unix + (t0 - self._anchor_mono), 6)
        return d

    def snapshot(self, session: Optional[str] = None,
                 signature: Optional[str] = None,
                 slower_than: Optional[float] = None,
                 trace: Optional[str] = None,
                 limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Filtered flight records, oldest first.  ``trace`` matches the
        record's own ``trace_id`` or any ``links`` entry (links are
        ``trace_id:span_id`` strings — prefix match, like
        ``tools/trace_view.py``)."""
        recs = [r for r in self._buf if r is not None]
        recs.sort(key=lambda r: r["seq"])
        out = []
        for r in recs:
            if session is not None and (
                    r.get("session") != session
                    and session not in (r.get("sessions") or ())):
                continue
            if signature is not None and r.get("signature") != signature:
                continue
            if slower_than is not None and r["device_s"] <= slower_than:
                continue
            if trace is not None and not (
                    r.get("trace_id") == trace
                    or any(ln.startswith(trace)
                           for ln in (r.get("links") or ()))):
                continue
            out.append(self._to_dict(r))
        if limit is not None and limit >= 0:
            out = out[-limit:]
        return out

    def dump(self, path: str) -> int:
        """Flush the ring as JSONL (crash-dump folding)."""
        recs = self.snapshot()
        with open(path, "w", encoding="utf-8") as fh:
            for d in recs:
                fh.write(json.dumps(d, separators=(",", ":")) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        return len(recs)

    def stats(self) -> Dict[str, Any]:
        recorded = 0
        for r in self._buf:
            if r is not None and r["seq"] >= recorded:
                recorded = r["seq"] + 1
        return {
            "capacity": self.capacity,
            "recorded": recorded,
            "dropped": max(0, recorded - self.capacity),
        }

    # -- armed-only registry families ------------------------------------

    def bind_metrics(self, m) -> None:
        m.counter_fn(
            "mpi_tpu_flight_records_total",
            "Dispatch flight records written (present only when "
            "--flight-recorder arms the ring)",
            lambda: self.stats()["recorded"])
        m.counter_fn(
            "mpi_tpu_flight_dropped_total",
            "Flight records overwritten by ring wrap",
            lambda: self.stats()["dropped"])
