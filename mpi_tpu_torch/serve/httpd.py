"""Threaded stdlib HTTP front end (``http.server``, the default).

The request semantics — routing, validation, manager verbs, error
mapping, wire-format negotiation, observability — live in
:class:`~mpi_tpu_torch.serve.transport.AppCore`; this module is the thin
transport: one ``BaseHTTPRequestHandler`` that packages each request into
a :class:`~mpi_tpu_torch.serve.transport.Request`, calls
``core.dispatch``, and writes the :class:`Response` back, with the
reference's header sequence (``mpi_tpu/serve/httpd.py``).

Routes, error shapes, deadline overrides, and the binary grid protocol
are documented on :mod:`mpi_tpu_torch.serve.transport` (one doc, N fronts).
The one route this front cannot serve is ``GET /stream/<sid>`` — a
blocking thread per open-ended stream is exactly the thread-per-idle-
client model the selectors front (``serve/aio.py``, ``--front aio``)
exists to replace — so the core answers it a structured 501 here.

The server is a ``ThreadingHTTPServer`` — requests against different
boards run concurrently; the per-session locks in ``session.py``
serialize requests against the same board, and concurrent
same-signature step requests are coalesced into stacked batched
steps by ``serve/batch.py`` (one kernel launch a pass for the batch).
"""

from __future__ import annotations

from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from mpi_tpu_torch.serve.session import SessionManager
from mpi_tpu_torch.serve.transport import AppCore, DEFAULT_MAX_BODY, Request


class _Handler(BaseHTTPRequestHandler):
    # the core is attached to the *server* by make_server; handlers are
    # constructed per request
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: D102 — quiet by default
        if getattr(self.server, "verbose", False):
            super().log_message(fmt, *args)

    def _run(self, method: str) -> None:
        core: AppCore = self.server.core
        req = Request(method, self.path, self.headers, self.rfile.read)
        resp = core.dispatch(req, transport="threaded")
        self.send_response(resp.code)
        self.send_header("Content-Type", resp.content_type)
        self.send_header("Content-Length", str(len(resp.body)))
        for name, value in resp.headers:
            self.send_header(name, value)
        if resp.close:
            # an unread request body (the 413 path) poisons keep-alive
            # framing: tell the client and drop the connection
            self.send_header("Connection", "close")
            self.close_connection = True
        self.end_headers()
        self.wfile.write(resp.body)

    # -- verbs -------------------------------------------------------------

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        self._run("GET")

    def do_POST(self):  # noqa: N802
        self._run("POST")

    def do_PUT(self):  # noqa: N802
        self._run("PUT")

    def do_DELETE(self):  # noqa: N802
        self._run("DELETE")


def make_server(host: str = "127.0.0.1", port: int = 0,
                manager: Optional[SessionManager] = None,
                verbose: bool = False,
                profile_dir: Optional[str] = None,
                max_body: int = DEFAULT_MAX_BODY) -> ThreadingHTTPServer:
    """A ready-to-run server (not yet serving — call ``serve_forever`` or
    drive it from a thread; ``port=0`` binds an ephemeral port, which the
    tests use).  The bound address is ``server.server_address``.
    ``manager=None`` builds ``SessionManager()``, which steps on the card;
    pass ``SessionManager(device="cpu")`` for the kernels' plain versions.
    Observability rides on the manager: ``manager.obs`` (or None) decides
    whether ``/metrics`` serves and spans record; ``profile_dir`` arms
    ``POST /debug/profile``."""
    server = ThreadingHTTPServer((host, port), _Handler)
    server.core = AppCore(manager, verbose=verbose, profile_dir=profile_dir,
                          max_body=max_body)
    # kept as server attributes too — tests and tools reach for these
    server.manager = server.core.manager
    server.verbose = verbose
    server.request_ids = server.core.request_ids
    server.obs = server.core.obs
    server.profile_dir = profile_dir
    return server
