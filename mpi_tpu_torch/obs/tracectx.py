"""W3C-``traceparent``-style trace context for cross-process stitching.

A request's trace identity is three ids: a 32-hex ``trace_id`` shared
by every span the request causes anywhere in the cluster, a 16-hex
``span_id`` naming one span, and the ``parent_span_id`` that makes the
set a tree.  The context is minted once at the serving edge (AppCore),
carried on the wire as an ``X-Gol-Traceparent`` header (the W3C
``00-<trace>-<span>-01`` shape) through one-hop proxy forwards and
stream redirects, and carried in-process by a ``ContextVar`` beside the
request id — so watchdog workers, the batch leader's thread hop, and
the async dispatcher (tickets persist their minting context) all record
spans under one trace id, end to end across processes.

The hot-path contract matches ``obs/trace.py``: a span recorded with no
ambient context costs one ``ContextVar.get`` and nothing else; span-id
generation (one ``os.urandom`` call) happens only on traced requests,
never on the bare ``manager.step`` path.
"""

from __future__ import annotations

import os
from contextvars import ContextVar
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

# Header carrying the context across process hops (proxy forwards, the
# /stream 307 redirect, and every instrumented response so clients can
# correlate logs and feed GET /debug/trace/<trace_id>).
TRACEPARENT_HEADER = "X-Gol-Traceparent"

_NULL_SPAN = "0" * 16


class TraceContext(NamedTuple):
    """``span_id is None`` marks an edge anchor: a context that parents
    spans but is not itself a span (a freshly minted trace's virtual
    root).  A parsed remote context keeps the remote span id, so local
    spans become its children in the stitched tree."""

    trace_id: str
    span_id: Optional[str] = None
    parent_span_id: Optional[str] = None

    def child(self) -> "TraceContext":
        return TraceContext(self.trace_id, _new_span_id(), self.span_id)

    def link(self) -> str:
        """Compact ``trace_id:span_id`` reference for span *links*
        (riders of a shared dispatch, related but not parented)."""
        return f"{self.trace_id}:{self.span_id or _NULL_SPAN}"


TRACE_CONTEXT: ContextVar[Optional[TraceContext]] = ContextVar(
    "mpi_tpu_torch_trace_context", default=None)


def _new_span_id() -> str:
    return os.urandom(8).hex()


def mint() -> TraceContext:
    """A fresh trace anchor for a request that arrived without a
    traceparent: new trace id, no span of its own — the first span
    recorded under it becomes the tree root."""
    return TraceContext(os.urandom(16).hex(), None, None)


def current_trace_context() -> Optional[TraceContext]:
    return TRACE_CONTEXT.get()


def set_trace_context(ctx: Optional[TraceContext]):
    """Returns a token for ``reset_trace_context``."""
    return TRACE_CONTEXT.set(ctx)


def reset_trace_context(token) -> None:
    TRACE_CONTEXT.reset(token)


def format_traceparent(ctx: TraceContext) -> str:
    return f"00-{ctx.trace_id}-{ctx.span_id or _NULL_SPAN}-01"


def parse_traceparent(value: Optional[str]) -> Optional[TraceContext]:
    """``00-<32hex>-<16hex>-<2hex>`` -> anchor context (the remote span
    becomes the local parent).  Anything malformed is ignored — a bad
    header must never fail a request, it just starts a fresh trace."""
    if not value:
        return None
    parts = value.strip().split("-")
    if len(parts) != 4:
        return None
    version, trace_id, span_id, _flags = parts
    if len(version) != 2 or version == "ff":
        return None
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16)
        int(span_id, 16)
    except ValueError:
        return None
    if trace_id == "0" * 32:
        return None
    if span_id == _NULL_SPAN:
        span_id = None
    return TraceContext(trace_id, span_id, None)


# -- stitching -------------------------------------------------------------


def stitch_spans(spans: List[Dict[str, Any]]) -> Tuple[
        List[Dict[str, Any]], List[Dict[str, Any]]]:
    """Order trace fragments from many nodes into one tree.

    ``spans`` are exported trace records (each node's ``t_unix`` already
    comes off its own monotonic+wall anchor pair, so wall ordering is
    the cross-node skew normalization).  Returns ``(ordered, roots)``:
    the flat list sorted by ``(t_unix, seq)``, and a nested tree where
    each node is ``{**span, "children": [...]}``; a span whose parent is
    not in the set (a virtual mint anchor, or a fragment lost to a dead
    peer) becomes a root."""
    ordered = sorted(spans, key=lambda r: (r.get("t_unix", 0.0),
                                           r.get("seq", 0)))
    by_id: Dict[str, Dict[str, Any]] = {}
    nodes: List[Dict[str, Any]] = []
    for rec in ordered:
        node = dict(rec)
        node["children"] = []
        nodes.append(node)
        sid = rec.get("span_id")
        if sid and sid not in by_id:
            by_id[sid] = node
    roots: List[Dict[str, Any]] = []
    for node in nodes:
        parent = by_id.get(node.get("parent_span_id") or "")
        if parent is not None and parent is not node:
            parent["children"].append(node)
        else:
            roots.append(node)
    return ordered, roots
