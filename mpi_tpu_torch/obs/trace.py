"""Span tracer: bounded ring buffer + optional JSONL stream.

The design target is the serve hot path: recording a span must cost
about as much as two ``perf_counter`` calls and a tuple store, because
it brackets work (device dispatch, lock waits) measured in tens of
microseconds on CPU.  So the ring is "lock-free-ish": slot indices come
from ``itertools.count()`` (whose ``__next__`` is atomic in CPython)
and each record is a single list-slot store — no lock, no allocation
beyond the record tuple itself.  Torn reads are possible at the wrap
boundary during a concurrent ``snapshot()``; that is acceptable for a
diagnostic buffer and is why records are immutable tuples (a slot is
either the old record or the new one, never half of each).

Timestamps are ``time.perf_counter()`` (monotonic, ns-resolution) so
durations are exact; a single (mono, unix) anchor pair captured at
tracer creation converts them to wall-clock at *export* time, keeping
``time.time()`` out of the hot path.

Request-id propagation uses a ``ContextVar`` so the id set by the HTTP
handler flows into every span recorded downstream on the same logical
request — including watchdog worker threads (via ``copy_context``) and
batched follower commits (the batcher stashes the id per entry and
re-enters it around each commit).  One id, end-to-end: that is what
makes a request's lifecycle greppable out of the JSONL.

Since schema v2 every record may additionally carry the distributed
trace context (``trace_id``/``span_id``/``parent_span_id``, see
``obs/tracectx.py``): a ``Span`` entered under an ambient context
allocates its own span id and re-parents descendants to itself for the
duration of the block, and events get leaf span ids.  Records emitted
outside any request (gossip, stream pushes, crash markers) carry no
trace keys — exactly like ``rid`` — which is also how v1 logs read
back: the context keys are optional everywhere.
"""

from __future__ import annotations

import itertools
import json
import os
import tempfile
import threading
import time
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

from mpi_tpu_torch.obs.tracectx import (
    TRACE_CONTEXT, TraceContext, reset_trace_context, set_trace_context,
)

# Ring/record layout and JSONL schema version: v1 records were
# (seq, name, t0, dur_s, rid, thread, fields); v2 appends the trace
# context triple (None outside a traced request).  The JSONL keys are
# strictly additive, so v1 readers and logs interoperate both ways.
TRACE_SCHEMA_VERSION = 2

# The one process-wide request-id slot.  httpd sets it at request entry;
# everything downstream (session, batcher, engine, recovery) reads it.
REQUEST_ID: ContextVar[Optional[int]] = ContextVar(
    "mpi_tpu_torch_request_id", default=None)


def current_request_id() -> Optional[int]:
    return REQUEST_ID.get()


def set_request_id(rid: Optional[int]):
    """Returns a token for ``reset_request_id``."""
    return REQUEST_ID.set(rid)


def reset_request_id(token) -> None:
    REQUEST_ID.reset(token)


class Span:
    """Context-manager span.  ``with tracer.span("x", sid=s) as sp:``
    records name/duration/tags on exit; an exception inside the block is
    recorded as an ``error`` field and re-raised."""

    __slots__ = ("_tracer", "name", "fields", "t0", "_ctx", "_ctx_token")

    def __init__(self, tracer: "Tracer", name: str, fields: Dict[str, Any]):
        self._tracer = tracer
        self.name = name
        self.fields = fields
        self.t0 = 0.0
        self._ctx: Optional[TraceContext] = None
        self._ctx_token = None

    def tag(self, **kv) -> "Span":
        self.fields.update(kv)
        return self

    @property
    def ctx(self) -> Optional["TraceContext"]:
        """This span's trace context (None outside a traced request)."""
        return self._ctx

    def __enter__(self) -> "Span":
        ctx = TRACE_CONTEXT.get()
        if ctx is not None:
            # this span becomes the parent of everything in the block
            self._ctx = ctx.child()
            self._ctx_token = set_trace_context(self._ctx)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self.t0
        if self._ctx_token is not None:
            reset_trace_context(self._ctx_token)
            self._ctx_token = None
        if exc_type is not None:
            self.fields["error"] = f"{exc_type.__name__}: {exc}"
        self._tracer._record(self.name, self.t0, dur, self.fields,
                             tctx=self._ctx)
        return False


class Tracer:
    def __init__(self, capacity: int = 4096,
                 log_path: Optional[str] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.log_path = log_path
        self._buf: List[Optional[tuple]] = [None] * capacity
        self._seq = itertools.count()
        # Anchor pair: wall time corresponding to a perf_counter reading,
        # taken once so export-time t_unix = anchor_unix + (t - anchor_mono).
        self._anchor_mono = time.perf_counter()
        self._anchor_unix = time.time()
        self._log_lock = threading.Lock()
        self._log_fh = None

    # -- recording -------------------------------------------------------

    def span(self, name: str, **fields) -> Span:
        return Span(self, name, fields)

    def event(self, name: str, dur_s: float = 0.0,
              t0: Optional[float] = None, **fields) -> None:
        """Record a point (or pre-measured interval) without the
        context-manager overhead — the hot-path primitive."""
        self._record(name, time.perf_counter() if t0 is None else t0,
                     dur_s, fields)

    def _record(self, name: str, t0: float, dur_s: float,
                fields: Dict[str, Any],
                tctx: Optional[TraceContext] = None) -> None:
        rid = fields.pop("rid", None)
        if rid is None:
            rid = REQUEST_ID.get()
        if tctx is None:
            # events are leaves: own span id, parented to the ambient
            # context (one ContextVar.get when untraced — hot-path safe)
            ctx = TRACE_CONTEXT.get()
            if ctx is not None:
                tctx = ctx.child()
        i = next(self._seq)
        rec = (i, name, t0, dur_s, rid,
               threading.current_thread().name, fields or None, tctx)
        self._buf[i % self.capacity] = rec
        if self.log_path is not None:
            self._stream(rec)

    def _stream(self, rec: tuple) -> None:
        try:
            with self._log_lock:
                if self._log_fh is None:
                    self._log_fh = open(self.log_path, "a",
                                        encoding="utf-8")
                self._log_fh.write(json.dumps(
                    self._to_dict(rec), separators=(",", ":")) + "\n")
                self._log_fh.flush()
        except OSError:
            # A full/yanked disk must not take the serve loop down.
            pass

    # -- export ----------------------------------------------------------

    def _to_dict(self, rec: tuple) -> Dict[str, Any]:
        i, name, t0, dur_s, rid, thr, fields, tctx = rec
        d: Dict[str, Any] = {
            "seq": i,
            "name": name,
            "t_unix": round(self._anchor_unix + (t0 - self._anchor_mono), 6),
            "t_mono": round(t0, 9),
            "dur_s": round(dur_s, 9),
            "thread": thr,
        }
        if rid is not None:
            d["rid"] = rid
        if tctx is not None:
            d["trace_id"] = tctx.trace_id
            d["span_id"] = tctx.span_id
            if tctx.parent_span_id is not None:
                d["parent_span_id"] = tctx.parent_span_id
        if fields:
            for k, v in fields.items():
                if k not in d:
                    d[k] = v
        return d

    def snapshot(self) -> List[Dict[str, Any]]:
        recs = [r for r in self._buf if r is not None]
        recs.sort(key=lambda r: r[0])
        return [self._to_dict(r) for r in recs]

    def dump(self, path: str) -> int:
        recs = self.snapshot()
        with open(path, "w", encoding="utf-8") as fh:
            for d in recs:
                fh.write(json.dumps(d, separators=(",", ":")) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
        return len(recs)

    def dump_on_crash(self, note: str = "") -> Optional[str]:
        """Called from the transport's catch-all 500 handler.  If already
        streaming to --trace-log the crash marker lands there; otherwise
        the ring is flushed to a tempdir file so the evidence survives."""
        self.event("crash_dump", note=note)
        if self.log_path is not None:
            return self.log_path
        path = os.path.join(tempfile.gettempdir(),
                            f"mpi_tpu_trace_crash_{os.getpid()}.jsonl")
        try:
            self.dump(path)
        except OSError:
            return None
        return path

    def stats(self) -> Dict[str, Any]:
        recorded = 0
        for r in self._buf:
            if r is not None and r[0] >= recorded:
                recorded = r[0] + 1
        return {
            "capacity": self.capacity,
            "recorded": recorded,
            "dropped": max(0, recorded - self.capacity),
            "streaming": self.log_path is not None,
            "schema": TRACE_SCHEMA_VERSION,
        }

    def close(self) -> None:
        with self._log_lock:
            if self._log_fh is not None:
                try:
                    self._log_fh.flush()
                    os.fsync(self._log_fh.fileno())
                    self._log_fh.close()
                except OSError:
                    pass
                self._log_fh = None
