"""The usage ledger: per-session and per-signature device-time metering
per plan signature.

One :class:`UsageLedger` hangs off the :class:`~mpi_tpu_torch.obs.Obs` handle
and is fed at the same commit sites that emit the dispatch trace events
(``device_dispatch`` in the solo step path, ``batched_dispatch`` in the
microbatch leader, ``unit_round`` in the async dispatch loop,
``host_step`` on the host backends).  ``obs=None`` means no ledger —
the step paths stay bit-identical to the pre-obs code.

Attribution rules (the tests in ``tests/test_usage.py`` hold them):

* one committed device sync = one :meth:`record` call, with the WHOLE
  sync's wall time (``t2 - t1``) — total device-seconds therefore
  reconcile exactly with the sum of dispatch-event durations;
* a batched dispatch splits that wall time EVENLY across its riders and
  records the amortization factor (rider shares sum to the leader's
  block time by construction);
* a failed batched/group attempt commits nothing here — the solo
  fallback re-enters the solo path, which records its own sync, so a
  fallback rider is never double-counted;
* an async unit-round chain is ONE sync (one ``block_until_ready`` per
  chain), however many depth-1 rounds it stacked;
* on the card every recorded wall ends after the launches it covers have
  run (``Engine.block_until_ready``), so it is device time plus the
  launch overhead, never the enqueue alone;
* the ledger is PROCESS-LOCAL: restore-from-checkpoint replays grids,
  not spend — a restart starts metering from zero (documented in the
  README's cardinality/persistence policy).

FLOP attribution is cost-card-derived (``obs/cost.py``): callers pass
each rider's share, already amortized, so the ledger never needs to see
an engine.
"""

from __future__ import annotations

import threading

KINDS = ("solo", "batched", "unit", "host")


def merge_totals(totals_list) -> dict:
    """Exact sum of N :meth:`UsageLedger.totals` payloads — the cluster
    roll-up arithmetic (``GET /usage``'s ``cluster.totals``).  Each
    input is a *cumulative* snapshot, so callers sum the LATEST snapshot
    per node, never deltas: re-merging after a duplicate or late gossip
    digest is idempotent by construction.  Integer fields stay exact
    integers; unknown ``by_kind`` keys are carried through (a newer
    peer's kinds must not be silently dropped)."""
    out = {"syncs": 0, "device_s": 0.0, "host_s": 0.0, "generations": 0,
           "cells": 0, "flops": 0.0, "by_kind": {k: 0 for k in KINDS}}
    for totals in totals_list:
        if not totals:
            continue
        out["syncs"] += int(totals.get("syncs", 0))
        out["device_s"] += float(totals.get("device_s", 0.0))
        out["host_s"] += float(totals.get("host_s", 0.0))
        out["generations"] += int(totals.get("generations", 0))
        out["cells"] += int(totals.get("cells", 0))
        out["flops"] += float(totals.get("flops", 0.0))
        for kind, count in (totals.get("by_kind") or {}).items():
            out["by_kind"][kind] = out["by_kind"].get(kind, 0) + int(count)
    return out


def _row():
    return {
        "device_s": 0.0,            # this row's share of engine sync wall
        "host_s": 0.0,              # serial_np fallback wall (not device)
        "dispatches": {k: 0 for k in KINDS},
        "generations": 0,
        "cells": 0,                 # cell-updates advanced
        "flops": 0.0,               # cost-card-derived share
        "rides": 0,                 # participations in B>1 syncs
        "boards": 0,                # sum of B over those rides
    }


def _finish(row: dict) -> dict:
    out = dict(row, dispatches=dict(row["dispatches"]))
    out["mean_amortization"] = (row["boards"] / row["rides"]
                                if row["rides"] else 1.0)
    return out


class UsageLedger:
    """Thread-safe usage accumulator (the dispatch sites run on the
    callers' threads, the batch leader, and the async dispatch loop)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sessions = {}         # sid -> row
        self._signatures = {}       # sig_label -> row (+ "syncs")
        self.syncs = 0              # committed device syncs (host included)
        self.device_s = 0.0
        self.host_s = 0.0
        self.generations = 0
        self.cells = 0
        self.flops = 0.0
        self.by_kind = {k: 0 for k in KINDS}
        # post-dispatch settlement hook (admission control's quota gate):
        # called OUTSIDE the ledger lock with (kind, dur_s, riders) after
        # every committed sync.  None (the default) costs one attribute
        # read — unarmed behavior is unchanged.
        self.settle_hook = None

    def record(self, kind: str, sig_label, dur_s: float, riders) -> None:
        """One committed sync.  ``riders`` is a sequence of
        ``(sid, generations, cells_advanced, flops_share)``; ``dur_s``
        is the whole sync's wall and is split evenly across them."""
        if kind not in self.by_kind:
            raise ValueError(f"unknown dispatch kind {kind!r}")
        riders = list(riders)
        if not riders:
            return
        share = dur_s / len(riders)
        label = sig_label or "-"
        time_key = "host_s" if kind == "host" else "device_s"
        with self._lock:
            self.syncs += 1
            self.by_kind[kind] += 1
            if kind == "host":
                self.host_s += dur_s
            else:
                self.device_s += dur_s
            sig = self._signatures.setdefault(label, dict(_row(), syncs=0))
            sig["syncs"] += 1
            sig[time_key] += dur_s
            sig["dispatches"][kind] += 1
            if len(riders) > 1:
                sig["rides"] += 1
                sig["boards"] += len(riders)
            for sid, gens, cells, flops in riders:
                self.generations += gens
                self.cells += cells
                self.flops += flops
                sig["generations"] += gens
                sig["cells"] += cells
                sig["flops"] += flops
                row = self._sessions.setdefault(sid, _row())
                row[time_key] += share
                row["dispatches"][kind] += 1
                row["generations"] += gens
                row["cells"] += cells
                row["flops"] += flops
                if len(riders) > 1:
                    row["rides"] += 1
                    row["boards"] += len(riders)
        hook = self.settle_hook
        if hook is not None:
            hook(kind, dur_s, riders)

    # -- read side (usage endpoint, describe/stats, scrape callbacks) -----

    def totals(self) -> dict:
        with self._lock:
            return {
                "syncs": self.syncs,
                "device_s": self.device_s,
                "host_s": self.host_s,
                "generations": self.generations,
                "cells": self.cells,
                "flops": self.flops,
                "by_kind": dict(self.by_kind),
            }

    def session_row(self, sid: str):
        with self._lock:
            row = self._sessions.get(sid)
            return _finish(row) if row is not None else None

    def session_rows(self) -> dict:
        with self._lock:
            return {sid: _finish(row)
                    for sid, row in self._sessions.items()}

    def signature_rows(self) -> dict:
        with self._lock:
            return {label: _finish(row)
                    for label, row in self._signatures.items()}

    def signature_series(self, field: str):
        """Per-signature label series for a scrape-time counter/gauge
        callback — bounded cardinality (signatures, never sessions)."""
        with self._lock:
            return [({"sig": label}, row[field])
                    for label, row in self._signatures.items()]
