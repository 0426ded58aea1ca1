"""``mpi_tpu_torch.serve`` — the serving session core on one GPU.

The one-shot engine (``run_cuda``) pays planning and warm-up on every
run and drives one board.  This package keeps the process alive
instead: an :class:`EngineCache` keeps built engines by plan signature
(``mpi_tpu_torch.config.plan_signature``), and a :class:`SessionManager`
owns N independent boards with device-resident state between requests,
stepped through kernels K1, K2 and K3 (``backends/cuda.py``).

A :class:`MicroBatcher` (``serve/batch.py``) sits on the step path:
concurrent same-signature same-depth steps are coalesced into one
stacked ``[B, ...]`` step, one kernel launch a pass for all B boards.
Batching is transparent — results are bitwise identical to solo stepping
and any batched-path failure falls back to the solo path.

Fault tolerance rides the same stack: crash-safe checkpoint/restore
(``serve/recovery.py``, a ``state_dir``; records are byte-compatible with
the reference's), request deadlines with a dispatch watchdog, a
per-plan-signature circuit breaker that degrades sick engines to the
bit-identical ``serial_np`` oracle, and deterministic fault injection
(``serve/faults.py``) to drive every recovery path under test.

Async ticketed stepping (``serve/ticket.py``) decouples the caller from
device submission: ``SessionManager.step_async`` returns a ticket at once
and a per-manager dispatch loop owns the device, decomposing depth-k
tickets into unit steps so mixed-depth sessions share batched launches.

Sessions may also name the host backends: ``serial`` (the numpy oracle)
and the native ``cpp``/``cpp-par`` engine.  ``SessionManager(obs=...)``
takes the observability handle of ``mpi_tpu_torch.obs``, and an armed
``mpi_tpu_torch.admission.AdmissionControl`` gates steps and creates by
tenant quota (429 with ``Retry-After``) before any kernel launch.

The network front splits transport from semantics, as the reference's
(``mpi_tpu.serve``) does: routing, validation and error mapping live in
the front-end-agnostic :class:`~mpi_tpu_torch.serve.transport.AppCore`;
``serve/wire.py`` defines the binary grid frame (``application/x-gol-grid``)
both checkpoint records and the fronts share; and two fronts drive the
core — the default threaded server (``serve/httpd.py:make_server``) and a
selectors event loop (``serve/aio.py:make_aio_server``, ``--front aio``)
that parks idle ticket waiters as sockets and pushes binary frames on
``GET /stream/<sid>``.  ``python -m mpi_tpu_torch.cli serve`` runs either
(``serve/cli.py``); with ``--peers`` several such processes serve as one
cluster (``mpi_tpu_torch/cluster``: sticky routing, one proxy hop,
gossip, failover and drain over a shared ``--state-dir``), and
``python -m mpi_tpu_torch.serve.scrub`` verifies a state dir offline.
"""

from mpi_tpu_torch.serve.batch import MicroBatcher
from mpi_tpu_torch.serve.cache import EngineCache
from mpi_tpu_torch.serve.faults import FaultInjector, FaultPlan, InjectedFault
from mpi_tpu_torch.serve.recovery import StateStore
from mpi_tpu_torch.serve.session import (
    DeadlineError,
    EngineStepError,
    EngineUnavailableError,
    SessionManager,
)
from mpi_tpu_torch.serve.ticket import (
    AsyncDispatcher, Ticket, TicketQueueFullError,
)
from mpi_tpu_torch.serve.httpd import make_server
from mpi_tpu_torch.serve.transport import AppCore
from mpi_tpu_torch.serve.wire import WireError, decode_frame, encode_frame

__all__ = [
    "EngineCache", "MicroBatcher", "SessionManager", "make_server",
    "StateStore", "FaultInjector", "FaultPlan", "InjectedFault",
    "DeadlineError", "EngineStepError", "EngineUnavailableError",
    "AsyncDispatcher", "Ticket", "TicketQueueFullError",
    "AppCore", "WireError", "encode_frame", "decode_frame",
]
