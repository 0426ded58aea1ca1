"""Known-bad ctxvar-hop cases: a thread/executor hop into code that
reads the rid contextvar without ``copy_context`` or a rid stash —
the callee sees ``None`` and its spans detach from the request.
Flagged lines carry ``# expect: ctxvar-hop``."""

import threading

from mpi_tpu_torch.obs.trace import REQUEST_ID, current_request_id


class Server:
    def handler(self):
        return current_request_id()

    def raw_reader(self):
        return REQUEST_ID.get()

    def launch_submit(self, pool):
        pool.submit(self.handler)           # expect: ctxvar-hop

    def launch_thread(self):
        t = threading.Thread(target=self.handler)  # expect: ctxvar-hop
        return t

    def launch_transitive(self, pool):
        def job():
            return self.raw_reader()

        pool.submit(job)                    # expect: ctxvar-hop
