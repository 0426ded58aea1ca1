"""SLO-driven load shedding.

A ``LoadShedder`` listens to the ``SloEngine``'s post-evaluate hook and
maintains a shed *level*: 0 sheds nothing, level 1 drops ``bulk``,
level 2 also drops ``standard``, level 3 drops everything including
``interactive`` (reachable only when ``max_level`` allows it; the
default stops at 2 so interactive traffic survives any automated
response).  Shedding answers 429 + Retry-After, the same shape as a
quota rejection.

Escalation and release reuse slo.py's flap-damping discipline, in both
directions: the *first* critical evaluation sheds bulk immediately
(worsening is immediate, exactly like SLO state transitions), but each
*further* level up needs ``damp_evals`` consecutive critical
evaluations at the current level, and each level down needs
``damp_evals`` consecutive non-critical evaluations — one flapping
window cannot ratchet the ladder to the top or release it early.
"""

from __future__ import annotations

import threading
from typing import Optional

from mpi_tpu_torch.admission.quota import AdmissionReject
from mpi_tpu_torch.admission.sched import CLASSES, CLASS_RANK


class ShedRejected(AdmissionReject):
    """Request dropped by the shed ladder, not by the tenant's quota."""


class LoadShedder:
    """The damped escalation ladder.  ``evaluate(worst)`` is called from
    the telemetry sampler with the SLO engine's worst state; request
    threads call ``check(tenant, qos)``."""

    def __init__(self, *, damp_evals: int = 3, max_level: int = 2,
                 retry_after_s: float = 30.0):
        self.damp_evals = max(1, int(damp_evals))
        self.max_level = max(0, min(len(CLASSES), int(max_level)))
        self.retry_after_s = float(retry_after_s)
        self._lock = threading.Lock()
        self.level = 0
        self._critical_streak = 0
        self._clear_streak = 0
        self.transitions = 0

    def evaluate(self, worst: str) -> int:
        """Feed one SLO evaluation; returns the (possibly new) level."""
        with self._lock:
            if worst == "critical":
                self._clear_streak = 0
                self._critical_streak += 1
                if self.level == 0:
                    self._set_level(1)
                elif self._critical_streak >= self.damp_evals:
                    self._critical_streak = 0
                    self._set_level(self.level + 1)
            else:
                self._critical_streak = 0
                if self.level > 0:
                    self._clear_streak += 1
                    if self._clear_streak >= self.damp_evals:
                        self._clear_streak = 0
                        self._set_level(self.level - 1)
            return self.level

    def _set_level(self, level: int) -> None:
        level = max(0, min(self.max_level, level))
        if level != self.level:
            self.level = level
            self.transitions += 1
            self._critical_streak = 0

    def sheds(self, qos: str) -> bool:
        """Level 1 sheds the lowest-ranked class, each further level one
        more: class rank >= len(CLASSES) - level is dropped."""
        return CLASS_RANK[qos] >= len(CLASSES) - self.level

    def check(self, tenant: str, qos: str) -> None:
        if self.level and self.sheds(qos):
            raise ShedRejected(
                f"shedding {qos!r} traffic (shed level {self.level}: SLO "
                f"critical)", tenant=tenant,
                retry_after_s=self.retry_after_s)
