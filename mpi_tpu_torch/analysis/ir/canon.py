"""Canonical form and fingerprint of a cell's launch records.

The drift baseline (``analysis/ir/baseline.json``) stores one fingerprint
per matrix cell.  It must hash only what the port itself decides, so that
the baseline blessed on the CPU holds on the card and across torch
versions (the reference's baseline, which hashes jaxprs, drifted on every
cell under another JAX):

* **kept**: each step's entry storage and the storage it returns, and
  every wrapper call in order, with its kernel, the rule's canonical text
  (``ops/gates.py:rule_key``), boundary, gens, shape, dtype,
  ``col_limit`` and the storages of its input and its ``out``; on a mesh,
  every ppermute of the halo exchange in its place among them (axis,
  pairs, slab shape); and for a
  sparse engine the phases its loop ran and the host reads it counted
  (``ops/activity.py``), which its launches alone may not show (on a busy
  board a sparse step launches what a dense one does);
* **renamed**: storages become ``s0, s1, ...`` in order of first use in
  that text, and an element offset into a storage is written ``s1+4096``;
* **dropped**: addresses, pids, device names, the aten ops between the
  calls (a torch version decomposes a line of PyTorch as it likes), and
  any launch geometry that depends on the card's SM count (such as the
  CTAs ``gol_bit_ctas_per_sm`` fits on an SM), which the record never
  holds.

The fingerprint is the first 16 hex digits of the SHA-256 of the text.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict, Sequence


@dataclass(frozen=True)
class CanonResult:
    text: str
    fingerprint: str


def canonicalize(steps: Sequence) -> CanonResult:
    """Canonical text and fingerprint of the recorded ``steps``
    (:class:`~.harness.Step`)."""
    from mpi_tpu_torch.analysis.ir.harness import Exchange, Launch

    names: Dict[int, str] = {}

    def name(ref) -> str:
        if ref.storage not in names:
            names[ref.storage] = f"s{len(names)}"
        base = names[ref.storage]
        return f"{base}+{ref.offset}" if ref.offset else base

    lines = []
    for i, step in enumerate(steps, start=1):
        lines.append(f"step {i} entry={name(step.entry)}")
        for ev in step.events:
            if isinstance(ev, Launch):
                shape = "x".join(str(n) for n in ev.shape)
                lines.append(
                    f"  {ev.kernel} rule={ev.rule} boundary={ev.boundary} "
                    f"gens={ev.gens} shape={shape} dtype={ev.dtype} "
                    f"col_limit={ev.col_limit} in={name(ev.src)} "
                    f"out={name(ev.out)}")
            elif isinstance(ev, Exchange):
                shape = "x".join(str(n) for n in ev.shape)
                pairs = ",".join(f"{a}>{b}" for a, b in ev.pairs)
                lines.append(f"  ppermute axis={ev.axis} pairs={pairs} "
                             f"slab={shape}")
        if step.phases:
            ran = " ".join(f"{k}={n}" for k, n in step.phases.items())
            lines.append(f"  phases {ran} reads={step.counted_reads}")
        lines.append(f"step {i} returns {name(step.returned)}")
    text = "\n".join(lines) + "\n"
    fp = hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]
    return CanonResult(text=text, fingerprint=fp)
