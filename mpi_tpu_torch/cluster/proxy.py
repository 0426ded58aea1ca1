"""One-hop HTTP proxying between cluster peers (stdlib ``http.client``).

A front that does not own a session forwards the request to the owner
and relays the response bytes verbatim — the client cannot tell which
process served it.  Forwarded requests carry the ``X-Gol-Forwarded``
header, which the receiving core treats as "handle locally, no matter
what the ring says": one hop maximum, so a stale routing view can never
loop a request around the slice.
"""

from __future__ import annotations

import http.client
from typing import Dict, Optional, Tuple

# set on every proxied request (value: the forwarding node's id); its
# presence short-circuits routing on the receiving side
FORWARDED_HEADER = "X-Gol-Forwarded"
# create-path only: the forwarding front chose the session id (ids are
# allocated by the front that takes the request so the ring placement
# decision and the id agree)
SESSION_ID_HEADER = "X-Gol-Session-Id"


class PeerUnreachable(RuntimeError):
    """The owning peer did not answer (connect/read failure or timeout).
    The transport layer maps this to the structured 503 — or, for ticket
    reads, the structured 404 the single-process restart contract
    already promises."""


def split_addr(addr: str) -> Tuple[str, int]:
    """``host:port`` -> (host, port); raises ValueError on junk."""
    host, _, port = addr.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"peer address must look like host:port, "
                         f"got {addr!r}")
    return host, int(port)


def proxy_request(addr: str, method: str, path: str, body: bytes = b"",
                  headers: Optional[Dict[str, str]] = None,
                  timeout_s: float = 5.0) -> Tuple[int, str, bytes]:
    """Send one request to ``addr`` and return ``(status, content_type,
    body)``.  Any transport-level failure raises :class:`PeerUnreachable`
    — an HTTP error *status* from the peer is a successful proxy (the
    peer's structured error is the answer)."""
    host, port = split_addr(addr)
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)
    try:
        conn.request(method, path, body=body or None, headers=headers or {})
        resp = conn.getresponse()
        data = resp.read()
        ctype = resp.getheader("Content-Type") or "application/json"
        return resp.status, ctype, data
    except (OSError, http.client.HTTPException) as e:
        raise PeerUnreachable(
            f"peer {addr} unreachable: {type(e).__name__}: {e}") from e
    finally:
        conn.close()
