"""The launch-level invariant checks.

Each check takes recorded-cell facts and returns :class:`IRFinding`\\ s.
They are pure functions over :class:`~.harness.RecordedCell` data (no
engines run here), so tests can seed violations — a seam stepper that
reads its band after the launch, an engine that hands back its input's
storage, a host read inside a dense step, a signature function with a
field dropped — and pin the exact diagnostics.

The fifth, ``ir-collective`` (:func:`check_collectives`), holds every
recorded ppermute of a mesh cell's halo exchange to the reference's rule:
a bijection of its mesh axis, the full ring when periodic, and a slab one
of ``parallel/halo.py:expected_slab_depths`` deep.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from mpi_tpu_torch.analysis.ir.harness import (
    Exchange, Launch, Op, RecordedCell, Step,
)
from mpi_tpu_torch.analysis.ir.matrix import near_pairs


@dataclass(frozen=True)
class IRFinding:
    """One diagnostic: ``cell <id>: [<check>] message``."""

    check: str
    cell: str
    message: str

    def format(self) -> str:
        return f"cell {self.cell}: [{self.check}] {self.message}"

    def fingerprint(self) -> str:
        raw = f"{self.check}:{self.cell}:{self.message}"
        return hashlib.sha256(raw.encode("utf-8")).hexdigest()[:16]


# -- ir-donation ----------------------------------------------------------

def _main_launches(rc: RecordedCell, step: Step) -> List[Launch]:
    """The step's launches on the grid itself (not the seam band, not a
    sparse stripe): those whose last two axes are a board's."""
    board = tuple(rc.engine._shape())
    return [ln for ln in step.launches if ln.shape[-2:] == board]


def _donation_pair(rc: RecordedCell) -> List[IRFinding]:
    """(i): the ping-pong pair, read off the two steps."""
    out: List[IRFinding] = []
    kept = None    # the storage step 1 kept as its spare
    for i, step in enumerate(rc.steps, start=1):
        mains = _main_launches(rc, step)
        if not mains:
            continue
        pair: Set[int] = {step.entry.storage, mains[0].out.storage}
        extra = sorted({r.storage for ln in mains for r in (ln.src, ln.out)}
                       - pair)
        if extra:
            out.append(IRFinding(
                "ir-donation", rc.cell.id,
                f"step {i} launches on {len(pair) + len(extra)} grid-sized "
                f"storages: an engine that consumes its input runs every "
                f"pass on the pair of its entry grid and its spare; a "
                f"third buffer means the donation was lost and every step "
                f"pays another grid"))
        if rc.engine.sparse_plan is None \
                and step.returned.storage != mains[-1].out.storage:
            out.append(IRFinding(
                "ir-donation", rc.cell.id,
                f"step {i} hands back a storage its last pass did not "
                f"write (the engine copies its result into its input and "
                f"returns that): the step pays a copy of the grid and "
                f"the pass's output is never handed over"))
        if kept is not None and mains[0].out.storage != kept:
            out.append(IRFinding(
                "ir-donation", rc.cell.id,
                f"step {i}'s first pass writes into a storage other than "
                f"the spare the step before kept (its input): the engine "
                f"did not reuse the consumed buffer, so the donation was "
                f"lost" if mains[0].out.storage != step.entry.storage else
                f"step {i}'s first pass writes into the grid the step "
                f"before handed back: the engine kept the caller's grid "
                f"as its spare"))
        kept = (pair - {step.returned.storage}).pop() if len(pair) == 2 \
            else None
    return out


def _compare_of_output(ev: Op, consumer: Launch) -> bool:
    """Whether ``ev`` is an elementwise compare of ``consumer``'s output
    with its input (the sparse engine's change maps)."""
    name = ev.name.split("::", 1)[-1]
    return (name in ("ne", "eq") and consumer.out.storage in ev.reads
            and consumer.src.storage in ev.reads)


def _reads_after_launch(rc: RecordedCell) -> List[IRFinding]:
    """(ii): no op reads a launch's input after the launch took it."""
    out: List[IRFinding] = []
    for i, step in enumerate(rc.steps, start=1):
        consumed: Dict[int, Tuple[int, Launch]] = {}  # storage -> launch
        n = 0
        for ev in step.events:
            if isinstance(ev, Launch):
                n += 1
                consumed.pop(ev.out.storage, None)
                consumed[ev.src.storage] = (n, ev)
                continue
            for s in ev.reads:
                if s in consumed and not _compare_of_output(
                        ev, consumed[s][1]):
                    k, ln = consumed[s]
                    entry = (" (the step's entry grid)"
                             if s == step.entry.storage else "")
                    out.append(IRFinding(
                        "ir-donation", rc.cell.id,
                        f"step {i}: {ev.name} reads the input of launch "
                        f"{k} ({ln.kernel}){entry} after the launch took "
                        f"it: a pass must read what it needs of its input "
                        f"before its kernel is launched, or in a launch of "
                        f"its own on the same stream, as the seam band "
                        f"does (parallel/seam.py), because the next pass "
                        f"writes into that buffer"))
            for s in ev.writes:
                consumed.pop(s, None)
    return out


def _entry_intact(rc: RecordedCell) -> List[IRFinding]:
    """(iii), an engine that does not donate (the mesh engine, whose every
    pass writes new shard tensors): no launch and no op of a step writes
    into the step's entry grid, any of its shards on a mesh."""
    out: List[IRFinding] = []
    for i, step in enumerate(rc.steps, start=1):
        entry = {step.entry.storage, *step.entry_shards}
        hits = [ev for ev in step.events
                if (isinstance(ev, Launch) and ev.out.storage in entry)
                or (isinstance(ev, Op) and entry & set(ev.writes))]
        if hits:
            what = hits[0].kernel if isinstance(hits[0], Launch) \
                else hits[0].name
            out.append(IRFinding(
                "ir-donation", rc.cell.id,
                f"step {i}: {what} writes into the step's entry grid, which "
                f"an engine that does not donate leaves as it was: every "
                f"pass must write new storage"))
    return out


def check_donation(rc: RecordedCell) -> List[IRFinding]:
    """The port's counterpart of the reference's donation-aliasing check,
    both directions.

    (i) An engine whose ``donates_input`` is true steps on a ping-pong
    pair: every pass on the grid reads and writes only the step's entry
    storage and the spare the engine kept; a step without sparse stepping
    hands back the output of its last pass; and the next step's first
    pass writes into the storage the step before kept, never into the grid
    it handed back.  (The reference requires donation markers in every
    non-seam program: a lost donation doubles peak memory.)  A pass never
    writes its own input, but a step of an even number of passes hands
    back the storage it was given, the pair's other half being the spare:
    so the contract is read per pass and across the two steps, not as
    "the step's result never aliases its input".

    (ii) Within one step, no op reads a launch's input after that launch
    has taken it, until something writes it again (the next pass writes
    into it), except an elementwise compare of the launch's output with
    that input (the sparse engine's change maps).  This is the seam race
    the reference's check pins (a seam program must not donate, because
    its band reads the pre-step grid): ``parallel/seam.py`` reads the
    band in a launch of its own right after the pass's.  It is read per
    launch, not as "no op reads the step's entry storage once a launch
    wrote it": the second pass of a seam step writes the entry storage,
    and its stitch must then read that pass's output there.

    (iii) An engine that does not donate (``donates_input`` false: the
    mesh engine) never writes its entry grid; (ii) is then moot, since no
    later pass writes into a launch's input."""
    if not rc.engine.donates_input:
        return _entry_intact(rc)
    out: List[IRFinding] = []
    out.extend(_donation_pair(rc))
    out.extend(_reads_after_launch(rc))
    return out


# -- ir-collective ----------------------------------------------------------

def check_collectives(rc: RecordedCell) -> List[IRFinding]:
    """Every recorded ppermute of the halo exchange must be a valid
    (partial) permutation of its mesh axis — the full ring on a periodic
    boundary, an injective chain on a dead one — and its slab must be one
    halo deep: ``k`` x rule radius for a pass of k <= comm_every, or the
    packed engines' single ghost word column
    (``parallel/halo.py:expected_slab_depths``)."""
    from mpi_tpu_torch.parallel.halo import expected_slab_depths
    from mpi_tpu_torch.parallel.mesh import AXES

    out: List[IRFinding] = []
    axis_sizes = {AXES[0]: rc.engine.mi, AXES[1]: rc.engine.mj}
    periodic = rc.config.boundary == "periodic"
    allowed = expected_slab_depths(
        rc.config.rule.radius, rc.config.comm_every, rc.engine.bitpacked)
    for rec in rc.collectives:
        n = axis_sizes.get(rec.axis)
        if n is None:
            out.append(IRFinding(
                "ir-collective", rc.cell.id,
                f"ppermute over unknown mesh axis {rec.axis!r} "
                f"(mesh axes: {sorted(axis_sizes)})"))
            continue
        srcs = [a for a, _ in rec.pairs]
        dsts = [b for _, b in rec.pairs]
        bad_range = [p for p in srcs + dsts if not 0 <= p < n]
        if bad_range:
            out.append(IRFinding(
                "ir-collective", rc.cell.id,
                f"ppermute over axis {rec.axis!r} (size {n}) names "
                f"out-of-range shards {sorted(set(bad_range))}: "
                f"pairs={list(rec.pairs)}"))
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            out.append(IRFinding(
                "ir-collective", rc.cell.id,
                f"ppermute over axis {rec.axis!r} is not a bijection: "
                f"duplicate "
                f"{'source' if len(set(srcs)) != len(srcs) else 'destination'}"
                f" in pairs={list(rec.pairs)} (a shard would receive two "
                f"halo slabs, or its ghost ring garbage)"))
        elif periodic and len(rec.pairs) != n:
            out.append(IRFinding(
                "ir-collective", rc.cell.id,
                f"periodic stepper's ppermute closes only "
                f"{len(rec.pairs)} of {n} ring links over axis "
                f"{rec.axis!r} (pairs={list(rec.pairs)}): an edge shard's "
                f"ghosts would arrive as zeros — dead-boundary semantics "
                f"on a periodic run"))
    for rec, thin in bad_slabs(rc.collectives, allowed):
        out.append(IRFinding(
            "ir-collective", rc.cell.id,
            f"halo slab shape {rec.shape} over axis {rec.axis!r} has "
            f"depth {thin}, expected one of {sorted(allowed)} (rule "
            f"radius {rc.config.rule.radius} x comm_every "
            f"{rc.config.comm_every}"
            f"{', or one ghost word column' if rc.engine.bitpacked else ''})"))
    return out


def bad_slabs(records: Sequence[Exchange],
              allowed) -> List[Tuple[Exchange, int]]:
    """The halo slabs among ``records`` whose depth is not in ``allowed``
    (``parallel/halo.py:expected_slab_depths``), each with its depth: the
    thinner side of the slab's own plane, its last two axes (a batch's
    leading board axis is no depth).  The slab contract of
    :func:`check_collectives` and of the tuner's winner-side bless."""
    out = []
    for rec in records:
        thin = min(rec.shape[-2:]) if rec.shape else 0
        if thin not in allowed:
            out.append((rec, thin))
    return out


# -- ir-purity --------------------------------------------------------------

def check_purity(rc: RecordedCell) -> List[IRFinding]:
    """The port's counterpart of the reference's impure-primitive check:
    host reads inside a step.  A step without sparse stepping makes none
    (no ``_local_scalar_dense``, no copy to the host, no ``nonzero``):
    each would stall the launch queue on the card.  A sparse step makes
    exactly the reads its phase loop counts (``ops/activity.py:
    make_sparse_evolve``, ``evolve.reads``: one per gather and probe
    decision)."""
    out: List[IRFinding] = []
    for i, step in enumerate(rc.steps, start=1):
        reads = step.host_reads
        want = step.counted_reads
        if len(reads) != want:
            names = sorted({op.name for op in reads})
            out.append(IRFinding(
                "ir-purity", rc.cell.id,
                f"step {i} reads the device back to the host {len(reads)} "
                f"time(s) ({', '.join(names) or 'none'}) where "
                + (f"its phase loop counts {want}"
                   if rc.engine.sparse_plan is not None else
                   "a step without sparse stepping makes none")
                + ": each read stalls the launch queue on the card"))
    return out


# -- ir-signature -----------------------------------------------------------

SignatureFn = Callable[[object, Tuple[int, int]], tuple]


def check_signatures(recorded: Sequence[RecordedCell],
                     signature_fn: Optional[SignatureFn] = None
                     ) -> List[IRFinding]:
    """Both directions of the EngineCache keying contract.

    Soundness: cells agreeing in (signature, depth, batch) must record
    identical canonical launches — a collision means ``EngineCache``
    would hand one config the other's engine.

    Completeness (via the matrix annotations): ``twin_of`` pairs differ
    only in signature-EXCLUDED fields, so their signatures must collide
    and their records must match; ``NEAR_PAIRS`` differ in exactly one
    signature-visible field, so their signatures must differ — and when
    depth/batch agree, so must their fingerprints (else the pair stopped
    exercising the field)."""
    out: List[IRFinding] = []
    if signature_fn is not None:
        def key_of(rc: RecordedCell) -> tuple:
            return (signature_fn(rc.config, (rc.engine.mi, rc.engine.mj)),
                    rc.cell.depth, rc.cell.batch)
    else:
        def key_of(rc: RecordedCell) -> tuple:
            return rc.group_key

    groups: Dict[tuple, List[RecordedCell]] = {}
    for rc in recorded:
        groups.setdefault(key_of(rc), []).append(rc)
    for key, members in groups.items():
        fps = {m.fingerprint for m in members}
        if len(fps) > 1:
            ids = sorted(m.cell.id for m in members)
            out.append(IRFinding(
                "ir-signature", ids[0],
                f"plan_signature collision: cells {', '.join(ids)} share a "
                f"plan signature (at depth {key[1]}, B={key[2]}) but "
                f"record different launches (fingerprints {sorted(fps)}): "
                f"EngineCache would hand one of them the other's engine"))

    by_id = {rc.cell.id: rc for rc in recorded}
    for rc in recorded:
        twin = by_id.get(rc.cell.twin_of) if rc.cell.twin_of else None
        if twin is None:
            continue
        if key_of(rc)[0] != key_of(twin)[0]:
            out.append(IRFinding(
                "ir-signature", rc.cell.id,
                f"cells {rc.cell.id} and {twin.cell.id} differ only in "
                f"signature-excluded fields (seed) but get distinct plan "
                f"signatures: engine sharing across sessions regressed"))
        elif rc.fingerprint != twin.fingerprint:
            out.append(IRFinding(
                "ir-signature", rc.cell.id,
                f"seed-only twins {rc.cell.id} and {twin.cell.id} record "
                f"different launches ({rc.fingerprint} != "
                f"{twin.fingerprint}): either the seed leaked into the "
                f"launch plan or canonicalization is unstable"))

    for a, b, fld in near_pairs([rc.cell for rc in recorded]):
        ra, rb = by_id[a.id], by_id[b.id]
        if key_of(ra)[0] == key_of(rb)[0]:
            out.append(IRFinding(
                "ir-signature", a.id,
                f"plan_signature is blind to field '{fld}': cells {a.id} "
                f"and {b.id} differ in it but share a signature — two "
                f"different plans would hit one EngineCache entry"))
        elif (a.depth, a.batch) == (b.depth, b.batch) \
                and ra.fingerprint == rb.fingerprint:
            out.append(IRFinding(
                "ir-signature", a.id,
                f"near-collision pair {a.id}/{b.id} (field '{fld}') "
                f"recorded identical launches: the matrix pair is inert "
                f"and no longer exercises the field"))
    return out


# -- ir-drift ---------------------------------------------------------------

def check_drift(recorded: Sequence[RecordedCell], baseline: Dict[str, dict],
                complete: bool = False) -> List[IRFinding]:
    """Compare each cell's canonical fingerprint to the checked-in
    baseline, blessed on the CPU and held on the card.  ``complete=True``
    (a full-matrix run) also flags stale entries whose cell is gone."""
    out: List[IRFinding] = []
    for rc in recorded:
        rec = baseline.get(rc.cell.id)
        if rec is None:
            out.append(IRFinding(
                "ir-drift", rc.cell.id,
                "no launch baseline recorded for this cell (bless with "
                "`python -m mpi_tpu_torch.analysis.ir --device cpu "
                "--write-baseline`)"))
        elif rec.get("fingerprint") != rc.fingerprint:
            out.append(IRFinding(
                "ir-drift", rc.cell.id,
                f"launch records drifted: canonical fingerprint "
                f"{rc.fingerprint} != baselined {rec.get('fingerprint')} "
                f"— if the change is intentional, bless it with `python "
                f"-m mpi_tpu_torch.analysis.ir --device cpu "
                f"--write-baseline` (and say why in the commit)"))
    if complete:
        live = {rc.cell.id for rc in recorded}
        for stale in sorted(set(baseline) - live):
            out.append(IRFinding(
                "ir-drift", stale,
                f"baseline entry for unknown cell '{stale}' (removed from "
                f"the matrix?) — regenerate with --write-baseline"))
    return out
