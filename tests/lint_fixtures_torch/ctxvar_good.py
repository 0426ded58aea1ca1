"""Safe thread-hop idioms the ``ctxvar-hop`` rule must NOT flag —
both serve-layer patterns: the copy_context wrap and the explicit rid
stash-and-restore."""

import contextvars
import threading

from mpi_tpu_torch.obs.trace import current_request_id, set_request_id


class Server:
    def handler(self):
        return current_request_id()

    def launch_wrapped(self, pool):
        """The watchdog pattern: carry the caller's context across."""
        ctx = contextvars.copy_context()
        pool.submit(ctx.run, self.handler)

    def launch_stashed(self, pool):
        """The Ticket.rid pattern: stash eagerly, reinstall in callee."""
        rid = current_request_id()

        def job():
            token = set_request_id(rid)
            return token

        pool.submit(job)

    def launch_oblivious(self, pool):
        """A callee that never touches the rid needs no wrapping."""
        def job():
            return 42

        pool.submit(job)
        t = threading.Thread(target=job)
        return t
