"""Known-bad lock-discipline cases, including the torn-read shape.

``describe_torn`` is the minimized torn read: generation and grid read
without ``session.lock``, so a concurrent step can commit between the
two loads and the pair tears (generation from one step, grid from
another).  Lines expected to be flagged carry
``# expect: lock-discipline``.
"""

import threading


class Session:
    def __init__(self):
        self.lock = threading.Lock()
        self.grid = None
        self.generation = 0
        self.closed = False

    def torn_self(self):
        return self.generation              # expect: lock-discipline


class Manager:
    def describe_torn(self, session):
        gen = session.generation            # expect: lock-discipline
        grid = session.grid                 # expect: lock-discipline
        return gen, grid

    def close_unlocked(self, session):
        session.closed = True               # expect: lock-discipline

    def run_chunk_unsorted(self, entries):
        for e in entries:                   # expect: lock-discipline
            e.session.lock.acquire()
        try:
            out = [e.session.grid for e in entries]
        finally:
            for e in entries:
                e.session.lock.release()
        return out


class AsyncDispatcher:
    def __init__(self):
        self._cv = threading.Condition()
        self._inbox = []

    def inbox_unlocked(self):
        self._inbox.append(1)               # expect: lock-discipline

    def inverted_order(self, session):
        with self._cv:
            with session.lock:              # expect: lock-discipline
                return session.grid
