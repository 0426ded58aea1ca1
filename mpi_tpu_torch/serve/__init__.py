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
takes the observability handle of ``mpi_tpu_torch.obs``.

This is the reference's session core (``mpi_tpu.serve``).  Its network
fronts (``transport``, ``httpd``, ``aio``, ``serve/cli``, and the
``/metrics``, ``/usage``, ``/debug/*`` endpoints), admission and cluster
come with the second half of ROADMAP queue 1 item 11b.
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
from mpi_tpu_torch.serve.wire import WireError, decode_frame, encode_frame

__all__ = [
    "EngineCache", "MicroBatcher", "SessionManager",
    "StateStore", "FaultInjector", "FaultPlan", "InjectedFault",
    "DeadlineError", "EngineStepError", "EngineUnavailableError",
    "AsyncDispatcher", "Ticket", "TicketQueueFullError",
    "WireError", "encode_frame", "decode_frame",
]
