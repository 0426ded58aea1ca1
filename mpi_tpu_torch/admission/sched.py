"""Priority classes and the weighted class scheduler.

Three classes, strictly ranked ``interactive > standard > bulk``.  A
tenant declares a ``default_class`` (what its requests get with no
override) and a ``max_class`` ceiling (the highest class it may
request); a per-request override is *capped* at the ceiling, never
rejected — asking for more than you are entitled to quietly gets you
your ceiling, the same discipline as a clamped nice value.

Head-of-line scheduling is smooth weighted round-robin over the classes
that currently have work (4:2:1): each pick adds every waiting class's
weight to its credit, takes the class with the most credit (ties go to
the higher-priority class), and debits the winner by the total weight in
play.  Interactive therefore dominates 4:2:1 under sustained load, and
no class with queued work waits more than a bounded number of rounds —
bulk cannot starve interactive *and* interactive cannot starve bulk.
Within the chosen class, tickets order by estimated device cost
ascending (CostCard ``ops_per_cell x cells``, computed at enqueue), so
a bulk mega-board never rides ahead of a viewport-sized request of the
same class.
"""

from __future__ import annotations

from typing import Dict, List, Optional

CLASSES = ("interactive", "standard", "bulk")
CLASS_RANK: Dict[str, int] = {c: i for i, c in enumerate(CLASSES)}
CLASS_WEIGHT: Dict[str, int] = {"interactive": 4, "standard": 2, "bulk": 1}
DEFAULT_CLASS = "standard"


def clamp_class(requested: Optional[str], ceiling: str) -> str:
    """The class a request actually gets: its ask, capped at the
    tenant's ceiling (a lower rank is a higher priority)."""
    if requested is None:
        return ceiling
    if CLASS_RANK[requested] < CLASS_RANK[ceiling]:
        return ceiling
    return requested


class WeightedClassPicker:
    """Smooth weighted round-robin over priority classes.  Deterministic
    (no randomness, no wall clock): the pick sequence for a fixed set of
    waiting classes is a pure function of how many picks came before.
    Callers serialize access (the dispatch loop is single-threaded)."""

    def __init__(self, weights: Optional[Dict[str, int]] = None):
        self.weights = dict(weights or CLASS_WEIGHT)
        self._credit: Dict[str, float] = {c: 0.0 for c in self.weights}

    def pick(self, waiting: List[str]) -> str:
        """The class served this round, from the classes with queued
        work.  Classes with nothing queued accrue no credit — an idle
        class cannot bank priority for later."""
        waiting = [c for c in CLASSES if c in waiting]
        if not waiting:
            raise ValueError("pick() needs at least one waiting class")
        if len(waiting) == 1:
            return waiting[0]
        total = 0
        for c in waiting:
            self._credit[c] += self.weights[c]
            total += self.weights[c]
        # max credit; ties go to the higher-priority (lower-rank) class,
        # which the CLASSES-ordered scan gives for free
        best = max(waiting, key=lambda c: self._credit[c])
        self._credit[best] -= total
        return best

    def reset(self) -> None:
        self._credit = {c: 0.0 for c in self.weights}
