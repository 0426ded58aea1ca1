"""``mpi_tpu_torch.analysis.ir`` — launch-level contract verifier.

The port's counterpart of ``mpi_tpu.analysis.ir``.  The AST suite
(:mod:`mpi_tpu_torch.analysis`) judges *syntax*; the reference's IR
contracts concern what the engine really executes, which in the port is
what the card launches.  The reference traces jaxprs without running
them; eager PyTorch has no abstract trace, so this verifier builds each
matrix cell's engine (:mod:`.matrix`) on a device and runs two steps of
it for real under a recorder (:mod:`.harness`): every kernel wrapper's
call, every ppermute of a mesh cell's halo exchange, and every aten op
between them.  The records are held to five contracts (:mod:`.checks`):

* ``ir-donation``   — both directions of the consume-the-input contract:
  each step runs on the ping-pong pair of its entry grid and the spare
  the engine kept, hands back its last pass's output and reuses the
  spare; and no op reads a launch's input after the launch took it (the
  seam band is itself a launch on it, right after the pass's); a mesh
  engine, which writes new shards every pass, never writes its entry
  grid.
* ``ir-purity``     — no host reads inside a step without sparse
  stepping; a sparse step makes exactly the reads its phase loop counts.
* ``ir-signature``  — ``plan_signature`` soundness both ways: equal
  (signature, depth, B) gives identical canonical records; near-pairs
  differ in signature and records; seed twins agree in both.
* ``ir-drift``      — canonical fingerprints of the launch records
  (:mod:`.canon`) per cell against the checked-in ``baseline.json``,
  blessed on the CPU with ``--write-baseline``; the card must match.
* ``ir-collective`` — on a mesh cell, every ppermute of the halo
  exchange is a bijection of its mesh axis, closes the ring when
  periodic, and ships a slab of one of
  ``parallel/halo.py:expected_slab_depths``.

Runner: ``python -m mpi_tpu_torch.analysis.ir`` (exit 0 clean / 1
findings / 2 internal error, as ``python -m mpi_tpu_torch.analysis``).
It runs on the card unless ``--device cpu`` asks for the CPU (the kernels'
plain versions), and with no card it exits 2: it never carries on on the
CPU.  ``--fast`` runs the fast tier; ``tests/test_torch_ir_verify.py``
runs it inside the tests, and ``chip_smoke.py`` phase 11 runs the whole
matrix on the card.

There are no inline suppressions: a launch record has no comment to hang
one on.  The only accepted override is the baseline (for drift) and
fixing the engine (for everything else).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

__all__ = [
    "BASELINE_PATH", "IRReport", "load_baseline", "run_ir", "write_baseline",
]

BASELINE_PATH = os.path.join(os.path.dirname(__file__), "baseline.json")


# -- baseline -------------------------------------------------------------

def load_baseline(path: Optional[str] = None) -> Dict[str, dict]:
    """cell_id -> {"fingerprint": ...} from the checked-in baseline."""
    path = path or BASELINE_PATH
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return data.get("cells", {})


def write_baseline(recorded, path: Optional[str] = None) -> str:
    """Bless the recorded cells' canonical fingerprints as the baseline."""
    path = path or BASELINE_PATH
    cells = {
        rc.cell.id: {"fingerprint": rc.fingerprint, "tier": rc.cell.tier}
        for rc in sorted(recorded, key=lambda rc: rc.cell.id)
    }
    payload = {
        "comment": "Canonical launch-record fingerprints per matrix cell "
                   "(mpi_tpu_torch/analysis/ir/canon.py), blessed on the "
                   "CPU and held on the card. Regenerate with `python -m "
                   "mpi_tpu_torch.analysis.ir --device cpu "
                   "--write-baseline` and justify the drift in the commit "
                   "message.",
        "cells": cells,
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(payload, f, indent=2, sort_keys=True)
        f.write("\n")
    return path


# -- runner ---------------------------------------------------------------

@dataclass
class IRReport:
    device: str = "cuda"
    findings: List = field(default_factory=list)   # List[IRFinding]
    errors: List[str] = field(default_factory=list)
    recorded: List = field(default_factory=list)   # List[RecordedCell]
    complete: bool = False   # full matrix (drift may judge staleness)

    @property
    def clean(self) -> bool:
        return not self.findings and not self.errors

    def launches(self) -> Dict[str, int]:
        """Wrapper calls by kernel id over every recorded step."""
        out = {"K1": 0, "K2": 0, "K3": 0}
        for rc in self.recorded:
            for kid, n in rc.launches_by_kernel.items():
                out[kid] = out.get(kid, 0) + n
        return out

    def to_json(self) -> dict:
        return {
            "tool": "mpi_tpu_torch.analysis.ir",
            "device": self.device,
            "findings": [
                {"check": f.check, "cell": f.cell, "message": f.message,
                 "fingerprint": f.fingerprint()}
                for f in self.findings
            ],
            "errors": list(self.errors),
            "summary": {
                "cells_recorded": len(self.recorded),
                "findings": len(self.findings),
                "errors": len(self.errors),
                "complete_matrix": self.complete,
                "launches": self.launches(),
                "host_reads": sum(rc.host_read_count
                                  for rc in self.recorded),
            },
            "cells": {
                rc.cell.id: rc.fingerprint for rc in self.recorded
            },
        }


def run_ir(device: str = "cuda", fast_only: bool = False,
           cell_ids: Optional[Sequence[str]] = None,
           use_baseline: bool = True,
           baseline_path: Optional[str] = None,
           signature_fn=None) -> IRReport:
    """Record the selected matrix cells on ``device`` and run every check.

    ``signature_fn`` overrides the plan-signature keying for the
    soundness check — the seeded-collision tests inject one with a field
    dropped and pin the resulting diagnostic."""
    from mpi_tpu_torch.analysis.ir import checks
    from mpi_tpu_torch.analysis.ir.harness import HarnessError, record_cell
    from mpi_tpu_torch.analysis.ir.matrix import cell_by_id, cells
    from mpi_tpu_torch.backends.cuda import resolve_device

    dev = resolve_device(device)
    if cell_ids:
        selected = [cell_by_id(c) for c in cell_ids]
    else:
        selected = cells(fast_only=fast_only)

    report = IRReport(device=dev.type,
                      complete=not fast_only and not cell_ids)
    for cell in selected:
        try:
            report.recorded.append(record_cell(cell, dev))
        except HarnessError as e:
            report.errors.append(str(e))

    for rc in report.recorded:
        report.findings.extend(checks.check_donation(rc))
        report.findings.extend(checks.check_purity(rc))
        report.findings.extend(checks.check_collectives(rc))
    report.findings.extend(
        checks.check_signatures(report.recorded, signature_fn=signature_fn))
    if use_baseline:
        report.findings.extend(checks.check_drift(
            report.recorded, load_baseline(baseline_path),
            complete=report.complete))
    return report
