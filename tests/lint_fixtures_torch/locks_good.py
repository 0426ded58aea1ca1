"""Clean lock-discipline idioms the rule must NOT flag."""

import threading


class Session:
    def __init__(self):
        self.lock = threading.Lock()
        self.grid = None
        self.generation = 0
        self.closed = False

    def snapshot(self):
        with self.lock:
            return self.generation, self.grid


class Manager:
    def describe(self, session):
        """The torn-read fix: both fields leave the lock together."""
        with session.lock:
            gen = session.generation
            grid = session.grid
        return gen, grid

    def run_chunk_sorted(self, entries):
        """The deadlock-freedom pattern: id-ordered acquisition."""
        entries.sort(key=lambda e: e.session.id)
        for e in entries:
            e.session.lock.acquire()
        try:
            out = [e.session.grid for e in entries]
        finally:
            for e in entries:
                e.session.lock.release()
        return out

    def step_then_signal(self, session, cv):
        """The documented order: session.lock first, _cv inside."""
        with session.lock:
            session.generation += 1


class AsyncDispatcher:
    def __init__(self):
        self._cv = threading.Condition()
        self._inbox = []

    def enqueue(self, item):
        with self._cv:
            self._inbox.append(item)
            self._cv.notify()

    def acquire_release(self):
        self._cv.acquire()
        try:
            return len(self._inbox)
        finally:
            self._cv.release()
