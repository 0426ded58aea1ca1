"""Suppression-mechanics fixture — exercised programmatically by
tests/test_torch_lint.py (no ``# expect`` markers here: a suppression
comment must be the last thing on its line, so the two syntaxes
cannot share one).

Three cases:
  * ``read_suppressed``  — valid suppression with a reason: finding dropped.
  * ``read_bare``        — suppression WITHOUT a reason: does not
    suppress, and itself raises a ``suppression`` finding.
  * ``read_plain``       — control: ordinary finding, no comment.
"""

import threading


class Session:
    def __init__(self):
        self.lock = threading.Lock()
        self.generation = 0


def read_suppressed(session):
    return session.generation  # lint: disable=lock-discipline -- fixture: scrape-time racy read is fine here


def read_bare(session):
    return session.generation  # lint: disable=lock-discipline


def read_plain(session):
    return session.generation
