"""Multi-tenant admission control: the control plane that turns the
usage ledger (``obs/ledger.py``) and the SLO engine (``obs/slo.py``) from
observers into actuators.

``AdmissionControl`` is the coordinator the serving stack talks to.  It
owns the :class:`TenantRegistry` (who exists, what they may spend), the
:class:`QuotaGate` (sliding-window spend books in ledger currency,
settled by a post-dispatch ledger hook), the
:class:`WeightedClassPicker` (cost-aware class scheduling inside the
async dispatcher), and the :class:`LoadShedder` (SLO-driven 429s,
lowest class first).

Everything here is **default-off**: an unarmed server has
``manager.admission is None``, registers none of the admission metric
families, adds no trace events, and serves byte-identical ids,
payloads, and scrape text (pinned by ``tests/test_torch_admission.py``).

Decision flow for one step request, armed:

1. transport resolves tenant (``X-Gol-Tenant`` header, default tenant
   when absent) and class (``X-Gol-Class``, capped at the tenant
   ceiling) and calls ``manager.admission_check``;
2. the shedder answers first (a critical SLO drops low classes before
   quota math runs), then the quota gate charges the CostCard
   *estimate* against the window's *settled* spend — cluster-wide when
   gossiping;
3. a rejection raises :class:`AdmissionReject` before any device work:
   no ``device_dispatch`` span, no ledger debit, a 429 with Retry-After
   and an ``admission_reject`` trace event;
4. on dispatch the ledger settlement hook charges what the step
   actually cost, so estimates never drift the books.

The estimate is the port's own: the engine's cost cards count K1-K3's
instructions (``obs/cost.py:capture_card``), divided by the card's int32
instruction rate (``obs/cost.py:roof_ops_per_s``: ``MPI_TPU_ROOF_OPS_PER_S``,
else the card's own rate, else the H100 roof this repo measured).  An
engine with no card yet has no cost card, and its estimate is 0
device-seconds: an unknown cost admits rather than guessing.

In cluster mode (``attach_cluster``) each quota gates against the
cluster-wide spend: this process's books plus the peers' gossiped window
snapshots.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from mpi_tpu_torch.admission.quota import AdmissionReject, QuotaExceeded, \
    QuotaGate, retry_after_header
from mpi_tpu_torch.admission.sched import CLASSES, DEFAULT_CLASS, \
    WeightedClassPicker
from mpi_tpu_torch.admission.shed import LoadShedder, ShedRejected
from mpi_tpu_torch.admission.tenants import DEFAULT_TENANT, TenantRegistry, \
    default_tenants, load_tenants_file, normalize_tenants
from mpi_tpu_torch.obs.cost import ops_per_cell_estimate, roof_ops_per_s

__all__ = [
    "AdmissionControl", "AdmissionReject", "QuotaExceeded", "ShedRejected",
    "TenantRegistry", "QuotaGate", "LoadShedder", "WeightedClassPicker",
    "CLASSES", "DEFAULT_CLASS", "DEFAULT_TENANT",
    "default_tenants", "load_tenants_file", "normalize_tenants",
    "retry_after_header",
]


class AdmissionControl:
    """Tenancy + quota + scheduling + shedding, armed as one unit."""

    def __init__(self, specs: Optional[Dict[str, dict]] = None, *,
                 damp_evals: int = 3, shed_max_level: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        self.registry = TenantRegistry(specs or default_tenants())
        self.gate = QuotaGate(self.registry, clock=clock)
        self.shedder = LoadShedder(damp_evals=damp_evals,
                                   max_level=shed_max_level)
        self.picker = WeightedClassPicker()
        self.obs = None
        self.manager = None
        self._lock = threading.Lock()
        # (tenant, decision) -> count; decision in admit|quota|shed
        self._decisions: Dict[Tuple[str, str], int] = {}
        # (tenant, class) -> admitted-step count (usage_top's class mix)
        self._class_mix: Dict[Tuple[str, str], int] = {}

    # -- resolution --------------------------------------------------

    def resolve(self, tenant_header: Optional[str]) -> str:
        return self.registry.resolve(tenant_header)

    def resolve_class(self, tenant: str, requested: Optional[str]) -> str:
        return self.registry.resolve_class(tenant, requested)

    # -- estimates ---------------------------------------------------

    def estimate_ops(self, session, steps: int) -> float:
        """Pre-dispatch cost estimate in device ops: CostCard
        ``ops_per_cell x cells`` over the whole request.  Zero until the
        engine has a card (first step of a fresh signature) — an unknown
        cost admits rather than guessing."""
        engine = getattr(session, "engine", None)
        if engine is None:
            return 0.0
        cells = session.config.cells
        try:
            per_cell = ops_per_cell_estimate(engine.cost_cards(), cells)
        except Exception:  # noqa: BLE001 — estimation must never reject
            return 0.0
        if not per_cell:
            return 0.0
        return per_cell * cells * int(steps)

    def estimate(self, session, steps: int) -> Tuple[float, int]:
        """(device-seconds, cells) the request is expected to cost: the
        cards' instructions over the roof (see the module doc)."""
        est_cells = int(steps) * session.config.cells
        est_device_s = self.estimate_ops(session, steps) / roof_ops_per_s()
        return est_device_s, est_cells

    # -- decisions ---------------------------------------------------

    def _count(self, tenant: str, decision: str) -> None:
        with self._lock:
            k = (tenant, decision)
            self._decisions[k] = self._decisions.get(k, 0) + 1

    def _reject_event(self, exc: AdmissionReject, decision: str,
                      qos: Optional[str]) -> None:
        if self.obs is not None:
            fields = {"tenant": exc.tenant, "decision": decision,
                      "retry_after_s": exc.retry_after_s}
            if qos is not None:
                fields["qos"] = qos
            self.obs.event("admission_reject", **fields)

    def admit_step(self, tenant: str, qos: str, est_device_s: float,
                   est_cells: int) -> None:
        """Gate one step request: shed ladder first (a critical SLO
        answers before quota math), then window quota.  Raises
        :class:`AdmissionReject`; counts every decision."""
        try:
            self.shedder.check(tenant, qos)
        except ShedRejected as e:
            self._count(tenant, "shed")
            self._reject_event(e, "shed", qos)
            raise
        try:
            self.gate.admit(tenant, est_device_s, est_cells)
        except QuotaExceeded as e:
            self._count(tenant, "quota")
            self._reject_event(e, "quota", qos)
            raise
        self._count(tenant, "admit")
        with self._lock:
            k = (tenant, qos)
            self._class_mix[k] = self._class_mix.get(k, 0) + 1

    def admit_session(self, tenant: str) -> None:
        """Gate a session create against the tenant's concurrency cap."""
        try:
            self.gate.admit_session(tenant)
        except QuotaExceeded as e:
            self._count(tenant, "quota")
            self._reject_event(e, "quota", None)
            raise
        self._count(tenant, "admit")

    # -- settlement (the post-dispatch ledger hook) -------------------

    def settle(self, kind: str, dur_s: float, riders) -> None:
        """Charge what a dispatch actually cost.  Mirrors the ledger's
        split: duration is shared evenly across riders; cells are each
        rider's own.  ``host`` work settles cells but not device time
        (the quota currency is device-seconds)."""
        if not riders:
            return
        share = dur_s / len(riders) if kind != "host" else 0.0
        for rider in riders:
            sid, _gens, cells = rider[0], rider[1], rider[2]
            tenant = self.gate.tenant_of(sid)
            if tenant is not None:
                self.gate.charge(tenant, share, cells)

    # -- arming ------------------------------------------------------

    def arm(self, manager, obs=None) -> None:
        """Wire into a live stack: install the ledger settlement hook,
        subscribe the shedder to SLO evaluations (when telemetry is
        armed), register the admission metric families, and hand the
        manager its admission handle."""
        self.manager = manager
        manager.admission = self
        self.obs = obs if obs is not None else getattr(manager, "obs", None)
        if self.obs is not None:
            self.obs.ledger.settle_hook = self.settle
            if self.obs.slo is not None:
                self.obs.slo.add_listener(
                    lambda worst: self.shedder.evaluate(worst))
            self.bind_metrics(self.obs.metrics)

    # -- read-outs ---------------------------------------------------

    def attach_cluster(self, node) -> None:
        """Quotas become cluster-wide: admit against local + gossiped
        peer window spend (exact sums — latest snapshot per node)."""
        self.gate.remote_spend = node.tenant_spend

    def window_snapshot(self) -> Dict[str, dict]:
        return self.gate.window_snapshot()

    def bind_metrics(self, m) -> None:
        """The four admission families, registered only when armed (an
        unarmed scrape carries none of them, like the SLO families)."""
        m.counter_fn(
            "mpi_tpu_admission_decisions_total",
            "Admission decisions by tenant and decision "
            "(admit|quota|shed)",
            self._decisions_read)
        m.gauge_fn(
            "mpi_tpu_shed_level",
            "Load-shed ladder level (0 none, 1 sheds bulk, 2 +standard, "
            "3 +interactive)",
            lambda: self.shedder.level)
        m.gauge_fn(
            "mpi_tpu_quota_remaining",
            "Device-seconds left in each tenant's sliding window "
            "(-1 = unlimited)",
            self._remaining_read)
        m.gauge_fn(
            "mpi_tpu_admission_queue_depth",
            "Queued async tickets by priority class",
            self._depth_read)

    def _decisions_read(self):
        with self._lock:
            items = sorted(self._decisions.items())
        return [({"tenant": t, "decision": d}, v) for (t, d), v in items]

    def _remaining_read(self):
        out = []
        for name in self.registry.names():
            limit = self.registry.get(name)["device_s_per_window"]
            if limit is None:
                out.append(({"tenant": name}, -1.0))
            else:
                spent, _ = self.gate.spent(name)
                out.append(({"tenant": name}, max(0.0, limit - spent)))
        return out

    def _depth_read(self):
        mgr = self.manager
        dispatcher = getattr(mgr, "dispatcher", None) if mgr else None
        depths = dispatcher.depth_by_class() if dispatcher is not None else {}
        return [({"class": c}, depths.get(c, 0)) for c in CLASSES]

    def tenants_block(self) -> dict:
        """The ``GET /usage`` ``tenants`` block: the shed level plus,
        per tenant, spend vs quota, live sessions, class mix, and
        decision counts."""
        with self._lock:
            decisions = dict(self._decisions)
            mix = dict(self._class_mix)
        by_tenant: Dict[str, dict] = {}
        for name in self.registry.names():
            spec = self.registry.get(name)
            device_s, cells = self.gate.spent(name)
            by_tenant[name] = {
                "window_s": spec["window_s"],
                "device_s": device_s,
                "device_s_per_window": spec["device_s_per_window"],
                "cells": cells,
                "cells_per_window": spec["cells_per_window"],
                "sessions": self.gate.sessions_of(name),
                "max_sessions": spec["max_sessions"],
                "default_class": spec["default_class"],
                "max_class": spec["max_class"],
                "class_mix": {c: mix.get((name, c), 0) for c in CLASSES
                              if mix.get((name, c))},
                "decisions": {d: decisions.get((name, d), 0)
                              for d in ("admit", "quota", "shed")
                              if decisions.get((name, d))},
            }
        return {"shed_level": self.shedder.level, "by_tenant": by_tenant}
