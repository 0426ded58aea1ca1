"""Unused-suppression fixture — exercised programmatically by
tests/test_torch_lint.py (like suppress_cases.py, no ``# expect`` markers:
a suppression comment must be the last thing on its line).

Four cases, judged under a ``rules=[lock-discipline]`` run:
  * ``used_ok``       — suppression that matches a real finding: used,
    nothing reported.
  * ``stale``         — suppression for an active rule on an already-clean
    line: reported as unused.
  * ``typo``          — suppression naming a rule that does not exist:
    reported (an unknown rule can never match anything).
  * ``inactive_rule`` — suppression for a KNOWN rule that is not part of
    this run: NOT reported (a --rule subset must not flag the tree's
    other justified suppressions).
"""

import threading


class Session:
    def __init__(self):
        self.lock = threading.Lock()
        self.generation = 0


def used_ok(session):
    return session.generation  # lint: disable=lock-discipline -- fixture: justified racy read


def stale(session):
    with session.lock:
        return session.generation  # lint: disable=lock-discipline -- fixture: lock already held, nothing to suppress


def typo(session):
    return session.generation  # lint: disable=lock-dicipline -- fixture: misspelled rule name


def inactive_rule(session):
    with session.lock:
        return session.generation  # lint: disable=traced-purity -- fixture: rule not in this run
