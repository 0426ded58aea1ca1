"""The probe loop: measure candidates, prune by the cost model, bless
winners.

Probing is real timing: build the candidate engine, run ``steps``
generations on the actual board, best of ``reps`` wall clocks around
``Engine.sync`` (the build of a kernel variant and the warm-up stay
outside the timed window), because the roofline gives a bound, not a
prediction.  The cost model prunes: before a candidate is timed, its ops
per cell come from its engine's cost card (``obs/cost.py:capture_card``,
the kernel's own int32 count; nothing is launched), and the candidate is
skipped when even an optimistic throughput bound cannot beat the best
measurement.

The bound never discards the incumbent, by construction: the reference
throughput ``R`` is the *demonstrated* ops/s, the most over measured
candidates of (measured cells/s x that candidate's ops/cell), floored by
the roof only when one was measured for this box
(``MPI_TPU_ROOF_OPS_PER_S``; never the card's peak rate, which would
over-prune), and a candidate's bound is ``margin · R / ops_per_cell`` with
``margin >= 1``.  The incumbent's own bound is therefore at least its own
measurement.  Sparse candidates are never pruned: their cost depends on
the board, and the card counts the dense pass.

Blessing, before a winner is persisted: a final board bit-identical to
the default plan's output and, on small boards, to the serial numpy
oracle (``backends/serial_np.py:evolve_np``); and on a mesh, for a plan
with comm_every > 1, the reference's halo-slab contract
(:func:`_slab_depths_ok`): every slab one pass of the candidate exchanges
is one of ``parallel/halo.py:expected_slab_depths`` deep, read off the
launch verifier's recorder (``analysis/ir/harness.py:Recorder``) where
the reference walks a jaxpr for its ppermutes.

A mesh is the config's ``mesh_shape``, or ``choose_mesh_shape`` of the
devices given (every card, or one device on the CPU), as the reference
picks its mesh; ``devices`` may name one card several times, for virtual
shards of it.

Kernel variants (CTA tiles) are built once, all together, before the
sweep (``ops/_build.py:build_rules`` for K1 and K3, ``build_variants``
for K2; one nvcc process per variant).
"""

from __future__ import annotations

import os
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from mpi_tpu_torch.config import GolConfig, apply_plan
from mpi_tpu_torch.tune.cache import TuneCache, platform_fingerprint
from mpi_tpu_torch.tune.space import Candidate, candidates

# how forgiving the prune bound is: a candidate is skipped only when
# margin x the demonstrated ops-throughput still cannot reach the best
# measured cells/s at the candidate's ops/cell
PRUNE_MARGIN = 2.0

# serial-oracle budget: evolve_np runs when cells x generations stays
# under this; beyond it, parity is judged against the default plan's
# output (itself held to the oracle by the tests at small sizes)
ORACLE_CELL_STEPS = 1 << 26


@dataclass
class Probe:
    """One candidate's outcome."""

    label: str
    plan: dict
    status: str                  # "measured" | "pruned" | "failed"
    cells_per_s: float = 0.0
    wall_s: float = 0.0
    ops_per_cell: Optional[float] = None
    bound_cells_per_s: Optional[float] = None
    parity: Optional[bool] = None
    detail: str = ""

    def as_dict(self) -> dict:
        d = {"label": self.label, "plan": self.plan, "status": self.status,
             "cells_per_s": round(self.cells_per_s, 1),
             "wall_s": round(self.wall_s, 6)}
        if self.ops_per_cell is not None:
            d["ops_per_cell"] = round(self.ops_per_cell, 3)
        if self.bound_cells_per_s is not None:
            d["bound_cells_per_s"] = round(self.bound_cells_per_s, 1)
        if self.parity is not None:
            d["parity"] = self.parity
        if self.detail:
            d["detail"] = self.detail
        return d


@dataclass
class TuneResult:
    """The winner and every probe."""

    config: GolConfig
    mesh_shape: Tuple[int, int]
    winner: dict = field(default_factory=dict)
    winner_label: str = "default"
    default_cells_per_s: float = 0.0
    tuned_cells_per_s: float = 0.0
    probes: List[Probe] = field(default_factory=list)
    pruned: int = 0
    oracle: str = "none"
    key: Optional[str] = None

    @property
    def speedup(self) -> float:
        if self.default_cells_per_s <= 0:
            return 1.0
        return self.tuned_cells_per_s / self.default_cells_per_s

    def as_dict(self) -> dict:
        return {
            "rows": self.config.rows, "cols": self.config.cols,
            "mesh": list(self.mesh_shape),
            "winner": self.winner, "winner_label": self.winner_label,
            "default_cells_per_s": round(self.default_cells_per_s, 1),
            "tuned_cells_per_s": round(self.tuned_cells_per_s, 1),
            "speedup": round(self.speedup, 3),
            "probed": sum(1 for p in self.probes
                          if p.status == "measured"),
            "pruned": self.pruned,
            "oracle": self.oracle,
            "probes": [p.as_dict() for p in self.probes],
            "key": self.key,
        }


def should_prune(ops_per_cell: float, demonstrated_ops_per_s: float,
                 best_cells_per_s: float,
                 margin: float = PRUNE_MARGIN) -> bool:
    """Skip a candidate whose optimistic bound cannot beat the best
    measurement.  ``margin`` is clamped to >= 1 so the bound stays an
    over-estimate: the incumbent's bound is at least its own measured
    cells/s, so it is never discarded."""
    if ops_per_cell <= 0 or demonstrated_ops_per_s <= 0:
        return False
    # compared as products (bound < best ⇔ margin·demonstrated <
    # best·opc): the division can land one ulp under the incumbent's own
    # measurement and discard it on rounding alone
    return (max(margin, 1.0) * demonstrated_ops_per_s
            < best_cells_per_s * ops_per_cell)


def candidate_bound(ops_per_cell: Optional[float],
                    demonstrated_ops_per_s: float,
                    margin: float = PRUNE_MARGIN) -> Optional[float]:
    if ops_per_cell is None or ops_per_cell <= 0 \
            or demonstrated_ops_per_s <= 0:
        return None
    return max(margin, 1.0) * demonstrated_ops_per_s / ops_per_cell


def _card_ops_per_cell(engine, depth: int, cells: int) -> Optional[float]:
    """int32 instructions per cell-update of the engine's step at
    ``depth``, from its cost card (the kernel's own count; no launch)."""
    from mpi_tpu_torch.obs.cost import capture_card, ops_per_cell_detail

    try:
        card = capture_card(engine, depth=depth, batch=0)
    except Exception:  # noqa: BLE001 — a cost estimate, never fatal
        return None
    return ops_per_cell_detail([card], cells)[0]


def _slab_depths_ok(engine, grid, depth: int) -> Tuple[bool, str]:
    """The winner-side ir-collective bless: one step of ``depth``
    generations of ``grid`` under the launch verifier's recorder, and
    every halo slab it exchanged must be one of the depths
    ``expected_slab_depths(radius, comm_every, packed)`` allows (its
    thinner side, as the reference reads a ppermute's operand)."""
    from mpi_tpu_torch.analysis.ir.checks import bad_slabs
    from mpi_tpu_torch.analysis.ir.harness import Recorder
    from mpi_tpu_torch.parallel.halo import expected_slab_depths

    cfg = engine.config
    allowed = expected_slab_depths(cfg.rule.radius, cfg.comm_every,
                                   engine.bitpacked)
    try:
        _, step = Recorder().record(
            lambda: engine.step(grid, depth), grid[0][0],
            lambda g: g[0][0], sync_debug=False,
            shards=[t for row in grid for t in row])
    except Exception as e:  # noqa: BLE001 — report, don't crash the tuner
        return False, f"slab record failed: {type(e).__name__}: {e}"
    bad = bad_slabs(step.exchanges, allowed)
    if bad:
        ex, thin = bad[0]
        return False, (f"halo slab {ex.shape} depth {thin} not in "
                       f"{sorted(allowed)}")
    return True, ""


def _measure(engine, board: np.ndarray, steps: int, reps: int,
             batch: int = 0, settle: int = 0) -> Tuple[float, np.ndarray]:
    """(best wall seconds, fetched final board) for ``steps`` generations:
    one untimed run first (the kernel's build, its warm-up and every pass
    depth), then the best of ``reps`` fresh runs, each timed between two
    ``Engine.sync`` calls.  ``settle`` > 0 advances that many untimed
    generations after each re-init, so a state-carrying engine (the sparse
    tile map starts all-changed) is timed in its steady regime; the board
    is then generation ``settle + steps`` for every candidate.  ``batch``
    > 0 times ``step_batched`` over B copies and reports the wall per
    board."""
    def run():
        if batch:
            grids = engine.init_grids(initials=[board] * batch)
            if settle:
                grids = engine.step_batched(grids, settle)
            engine.sync()
            t0 = time.perf_counter()
            grids = engine.step_batched(grids, steps)
            engine.sync()
            return time.perf_counter() - t0, grids
        g = engine.init_grid(initial=board)
        if settle:
            g = engine.step(g, settle)
        engine.sync()
        t0 = time.perf_counter()
        g = engine.step(g, steps)
        engine.sync()
        return time.perf_counter() - t0, g

    engine.warm_up(boards=batch)
    _, out = run()                       # warm: build, every depth
    best = float("inf")
    for _ in range(max(reps, 1)):
        wall, out = run()
        best = min(best, wall)
    if batch:
        final = engine.fetch_batched(out)[0]
        best = best / batch              # per-board wall
    else:
        final = engine.fetch(out)
    return best, np.asarray(final)


def _prebuild(config: GolConfig, space: List[Candidate], device,
              log) -> None:
    """Build every CTA-tile variant of ``space`` once, all together (one
    nvcc process per variant), before the sweep times any of them.  A
    failed build is left to its candidate's probe, which fails alone."""
    import torch

    from mpi_tpu_torch.backends.cuda import BLOCK_DEFINES, plan_engine
    from mpi_tpu_torch.ops import _build

    if torch.device("cuda" if device is None else device).type != "cuda":
        return
    variants = {}
    for cand in space:
        if cand.plan.get("blocks") is None:
            continue
        try:
            kind = plan_engine(apply_plan(config, cand.plan))[0]
            defines = BLOCK_DEFINES[kind](cand.plan["blocks"])
        except Exception:  # noqa: BLE001 — judged at the candidate's probe
            continue
        variants.setdefault(kind, []).append(defines)
    for kind, defines in variants.items():
        t0 = time.perf_counter()
        try:
            if kind == "dense":  # K2 reads its rule at run time
                _build.build_variants(defines)
            else:
                _build.build_rules(kind, [config.rule] * len(defines),
                                   defines)
        except Exception as e:  # noqa: BLE001 — each probe fails alone
            log(f"building {kind} variants failed: {e}")
        log(f"built {len(defines)} {kind} variants in "
            f"{time.perf_counter() - t0:.1f} s")


def tune_plan(config: GolConfig, *, device=None, devices=None,
              board: Optional[np.ndarray] = None,
              steps: int = 64, reps: int = 2, settle: int = 0,
              cache: Optional[TuneCache] = None,
              cands: Optional[List[Candidate]] = None,
              include_batch: bool = False,
              margin: float = PRUNE_MARGIN,
              min_speedup: float = 1.05,
              verbose: bool = False) -> TuneResult:
    """Search the plan space for ``config`` on ``device`` (the card when
    None); persist the blessed winner.  ``devices``: those a mesh may
    span (default every card, or one device on the CPU, whose meshes run
    on its virtual devices).

    ``board`` defaults to the config's seeded grid (every probe starts
    from the same state).  ``settle`` advances untimed generations before
    each timed window (parity then compares boards at generation
    ``settle + steps``).  ``cands`` overrides the generated space (tests).
    The winner is recorded in ``cache`` (when given) even when the default
    plan wins: an empty-plan entry tells the next run that tuning already
    happened."""
    from mpi_tpu_torch.backends.cuda import build_engine, resolve_device
    from mpi_tpu_torch.parallel.mesh import (
        choose_mesh_shape, mesh_over, visible_devices,
    )

    dev = resolve_device(device)
    if devices is None and dev.type == "cuda":
        devices = visible_devices("cuda")
    mesh_shape = tuple(config.mesh_shape or choose_mesh_shape(
        1 if devices is None else len(devices)))
    cells = config.cells

    def build(cfg, blocks=None):
        return build_engine(cfg, mesh=mesh_over(mesh_shape, devices, device),
                            blocks=blocks)

    def log(msg):
        if verbose:
            print(f"tune: {msg}", file=sys.stderr)

    res = TuneResult(config=config, mesh_shape=mesh_shape)
    space = cands if cands is not None else candidates(
        config, mesh_shape, include_batch=include_batch, device=device)
    # -- incumbent: the default plan, measured first -----------------------
    default_eng = build(config)
    if board is None:
        board = default_eng.fetch(default_eng.init_grid())
    wall, default_out = _measure(default_eng, board, steps, reps,
                                 settle=settle)
    res.default_cells_per_s = cells * steps / wall if wall > 0 else 0.0
    opc0 = _card_ops_per_cell(default_eng, config.comm_every, cells)
    res.probes.append(Probe("default", {}, "measured",
                            cells_per_s=res.default_cells_per_s,
                            wall_s=wall, ops_per_cell=opc0, parity=True))
    log(f"default: {res.default_cells_per_s:.3g} cells/s "
        f"(ops/cell {opc0 if opc0 is None else round(opc0, 2)})")
    # oracle: serial numpy when affordable, else the default plan's output
    oracle_out = default_out
    res.oracle = "default-plan"
    if cells * (settle + steps) <= ORACLE_CELL_STEPS:
        from mpi_tpu_torch.backends.serial_np import evolve_np

        oracle_out = evolve_np(board, settle + steps, config.rule,
                               config.boundary)
        res.oracle = "serial-numpy"
        if not np.array_equal(default_out, oracle_out):
            raise AssertionError(
                "default plan does not match the serial oracle — refusing "
                "to tune on top of a broken baseline")
    # demonstrated ops-throughput: what the card has been seen to sustain,
    # floored by a roof measured for this box (never the card's peak rate,
    # which would over-prune)
    demonstrated = 0.0
    if opc0:
        demonstrated = res.default_cells_per_s * opc0
    env_roof = os.environ.get("MPI_TPU_ROOF_OPS_PER_S")
    if env_roof:
        try:
            demonstrated = max(demonstrated, float(env_roof))
        except ValueError:
            pass
    best_cells = res.default_cells_per_s
    best_plan: dict = {}
    best_label = "default"
    _prebuild(config, space, device, log)
    # -- the sweep ---------------------------------------------------------
    for cand in space:
        if cand.is_default:
            continue
        batch = int(cand.plan.get("batch", 0) or 0)
        try:
            tuned_cfg = apply_plan(config, cand.plan)
        except Exception as e:  # noqa: BLE001 — infeasible = skipped
            res.probes.append(Probe(cand.label, dict(cand.plan), "failed",
                                    detail=f"{type(e).__name__}: {e}"))
            continue
        try:
            eng = default_eng if batch and not cand.plan.get("blocks") \
                and tuned_cfg == config else build(
                    tuned_cfg, blocks=cand.plan.get("blocks"))
            opc = None
            if not cand.data_dependent and not batch:
                opc = _card_ops_per_cell(eng, tuned_cfg.comm_every, cells)
                if opc is not None and should_prune(
                        opc, demonstrated, best_cells, margin):
                    res.pruned += 1
                    res.probes.append(Probe(
                        cand.label, dict(cand.plan), "pruned",
                        ops_per_cell=opc,
                        bound_cells_per_s=candidate_bound(
                            opc, demonstrated, margin)))
                    log(f"{cand.label}: pruned (ops/cell {opc:.2f})")
                    continue
            wall, out = _measure(eng, board, steps, reps, batch=batch,
                                 settle=settle)
            tput = cells * steps / wall if wall > 0 else 0.0
            parity = np.array_equal(out, oracle_out)
            probe = Probe(cand.label, dict(cand.plan), "measured",
                          cells_per_s=tput, wall_s=wall, ops_per_cell=opc,
                          parity=parity)
            if not parity:
                probe.status = "failed"
                probe.detail = "output differs from oracle"
                res.probes.append(probe)
                log(f"{cand.label}: PARITY FAILURE — discarded")
                continue
            if tuned_cfg.comm_every > 1 and mesh_shape != (1, 1):
                ok, why = _slab_depths_ok(
                    eng, eng.init_grid(initial=board), tuned_cfg.comm_every)
                if not ok:
                    probe.status = "failed"
                    probe.detail = why
                    res.probes.append(probe)
                    log(f"{cand.label}: IR contract failure ({why})")
                    continue
            res.probes.append(probe)
            if opc:
                demonstrated = max(demonstrated, tput * opc)
            log(f"{cand.label}: {tput:.3g} cells/s "
                f"({tput / max(res.default_cells_per_s, 1e-12):.2f}x)")
            if tput > best_cells:
                best_cells, best_plan, best_label = \
                    tput, dict(cand.plan), cand.label
        except Exception as e:  # noqa: BLE001 — one sick candidate must
            # not kill the sweep (a failed variant build, a refused plan)
            res.probes.append(Probe(cand.label, dict(cand.plan), "failed",
                                    detail=f"{type(e).__name__}: {e}"))
            log(f"{cand.label}: failed ({type(e).__name__}: {e})")
    # -- bless -------------------------------------------------------------
    if best_plan and best_cells < res.default_cells_per_s * min_speedup:
        # a winner inside the noise band is not a winner
        best_plan, best_label, best_cells = \
            {}, "default", res.default_cells_per_s
    res.winner, res.winner_label = best_plan, best_label
    res.tuned_cells_per_s = best_cells
    if cache is not None:
        measured = {
            "default_cells_per_s": round(res.default_cells_per_s, 1),
            "tuned_cells_per_s": round(res.tuned_cells_per_s, 1),
            "speedup": round(res.speedup, 3),
            "steps": steps, "reps": reps, "settle": settle,
            "probed": sum(1 for p in res.probes if p.status == "measured"),
            "pruned": res.pruned,
            "oracle": res.oracle,
        }
        res.key = cache.record(config, mesh_shape, best_plan, measured,
                               platform=platform_fingerprint(device))
        cache.save()
        log(f"winner {best_label} persisted to {cache.path}")
    return res
