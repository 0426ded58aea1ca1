"""Candidate plan generation for the autotuner.

The search space is the knobs the port already has:

* ``comm_every`` k: generations per kernel pass, the kernels'
  temporal-blocking depth;
* ``sparse_tile`` T: the activity-gated engine's tile side;
* ``blocks``: the CTA tile of kernel K1 (``[rows, words a lane]``,
  ``-DK1_ROWS``/``-DK1_WPL`` of ``csrc/bitlife.cu``), K3 (``[rows]``,
  ``-DK3_ROWS`` of ``csrc/bitltl.cu``) or K2 (``[rows, cols]``,
  ``-DK2_ROWS``/``-DK2_COLS`` of ``csrc/stencil.cu``, the reference's
  dense ``(BM, SR)`` block plane), a build variant of the kernel, proposed
  on the card only;
* ``batch`` B: a serving hint for the microbatcher, probed but never
  applied to the solo program.

Feasibility is judged by the rules the build path runs
(:func:`~mpi_tpu_torch.tune.cache.validate_plan`: ``apply_plan``, then
``GolConfig.__post_init__``, the ghost ring's size on the one device or
the shards' on a mesh (``validate_mesh``), and a tile's screen): the space
enumerates, the config rules decide.  On a mesh it proposes what the
reference's does there: comm_every (and the batch hint), no sparse tile
and no CTA tile.  The
default plan is always candidate 0: the incumbent every bound is measured
against and the parity reference every winner must match bit for bit.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

from mpi_tpu_torch.config import ConfigError, GolConfig
from mpi_tpu_torch.tune.cache import validate_plan

COMM_EVERY_CANDIDATES = (2, 4, 8)
SPARSE_TILE_CANDIDATES = (32, 64, 128, 256)
MAX_BLOCK_CANDIDATES = 6   # per (plan-prefix) axis: keeps sweeps bounded


@dataclass(frozen=True)
class Candidate:
    """One point of the plan space: the override dict (empty = the
    default plan) and a label."""

    plan: dict = field(default_factory=dict)
    label: str = "default"

    @property
    def is_default(self) -> bool:
        return not self.plan

    @property
    def data_dependent(self) -> bool:
        """Whether this candidate's cost depends on the board (the sparse
        engine's tile map): such candidates are never pruned by the
        static ops bound, which counts the dense pass."""
        return bool(self.plan.get("sparse_tile"))


def _feasible(config: GolConfig, mesh_shape: Tuple[int, int],
              plan: dict) -> bool:
    try:
        validate_plan(config, mesh_shape, plan)
    except ConfigError:
        return False
    return True


def _block_candidates(config: GolConfig, mesh_shape: Tuple[int, int],
                      gens: Optional[int] = None,
                      device=None) -> Iterator[Candidate]:
    """CTA-tile overrides, only on the card (``device`` None or CUDA):
    off the card the plain versions have no tile, so nothing is proposed.

    K1 (radius 1): ``[rows, wpl]`` over words a lane (4, 2, 1) and rows
    (32, 64, 128, 256, 512), smallest first, so that the cap keeps the
    tiles that add CTAs: on the grids the tuner runs at, the default tile
    leaves most of the card's SMs idle.  K3 (radius 2..7 on the
    bit-sliced route): ``[rows]``, the rows a warp steps, over
    (32, 64, 128, 512) beside the default 256.  K2 (the dense
    route: radius > 1 past K3's depth, or widths the packed engines
    decline): ``[rows, cols]`` over rows (32..512) and columns (128, 256,
    512), the smallest tile first (the most CTAs), and among equal ones
    the one that loads the fewest halo cells per owned cell at the pass's
    depth.  Each is screened by its kernel's own limit
    (``cuda_bitlife.blocks_ok``, ``cuda_bitltl.blocks_ok``: the deepest
    pass's shared memory, which the library claims for every pass;
    ``cuda_stencil.blocks_ok`` at the candidate's own pass depth), the
    default build's tile is excluded (it IS the incumbent), and at most
    ``MAX_BLOCK_CANDIDATES`` are proposed.  ``gens`` validates the
    candidates at another depth than the config's (the paired
    (comm_every, blocks) plane of :func:`candidates`).

    Pruning soundness (``tuner.should_prune``): a tile changes no kernel
    count, so a blocks candidate's bound equals the incumbent's at its
    depth and it is never wrongly pruned."""
    import torch

    if tuple(mesh_shape) != (1, 1):
        return
    if torch.device("cuda" if device is None else device).type != "cuda":
        return
    from mpi_tpu_torch.backends.cuda import deepest_pass, plan_engine
    from mpi_tpu_torch.ops import cuda_bitlife, cuda_bitltl, cuda_stencil

    tag = "" if gens is None else f"comm_every={gens},"
    base = {} if gens is None else {"comm_every": gens}
    if gens is None:
        gens = config.comm_every
    try:
        cfg = (dataclasses.replace(config, comm_every=gens)
               if gens != config.comm_every else config)
    except ConfigError:
        return
    kind = plan_engine(cfg)[0]
    r = config.rule.radius
    if kind == "bit":
        auto = [cuda_bitlife.rows_for(gens), 4]
        tiles = [[rows, wpl] for wpl in cuda_bitlife.BLOCK_WPL
                 for rows in sorted(cuda_bitlife.BLOCK_ROWS)
                 if cuda_bitlife.blocks_ok(rows, wpl, config.rows)]
    elif kind == "ltl":
        auto = [cuda_bitltl.DEFAULT_ROWS]
        tiles = [[rows] for rows in sorted(cuda_bitltl.BLOCK_ROWS)
                 if cuda_bitltl.blocks_ok(rows, r, config.rows)]
    else:
        auto = cuda_stencil.DEFAULT_TILE
        depth = deepest_pass(cfg, kind)
        halo = min(depth, cuda_stencil.MAX_DEPTH // r) * r
        tiles = sorted(
            ([rows, cols] for rows in cuda_stencil.BLOCK_ROWS
             for cols in cuda_stencil.BLOCK_COLS
             if cuda_stencil.blocks_ok(rows, cols, r, depth, config.rows)),
            key=lambda t: (t[0] * t[1],
                           (t[0] + 2 * halo) * (t[1] + 32) / (t[0] * t[1])))
    count = 0
    for tile in tiles:
        if tile == auto:
            continue
        yield Candidate({**base, "blocks": tile},
                        f"{tag}blocks={'x'.join(map(str, tile))}")
        count += 1
        if count >= MAX_BLOCK_CANDIDATES:
            return


def candidates(config: GolConfig, mesh_shape: Tuple[int, int],
               include_batch: bool = False, device=None) -> List[Candidate]:
    """The ordered candidate list for one requested config on ``device``
    (the card when None): the default plan first (the incumbent), then
    every feasible single-knob and paired variant.  Knob values the
    request already pinned are not searched (a user asking for
    ``comm_every=4`` keeps it)."""
    out: List[Candidate] = [Candidate()]
    if config.backend != "cuda":
        return out
    deepest_k = None
    if config.comm_every == 1:
        for k in COMM_EVERY_CANDIDATES:
            plan = {"comm_every": k}
            if _feasible(config, mesh_shape, plan):
                out.append(Candidate(plan, f"comm_every={k}"))
                deepest_k = k
    if config.sparse_tile == 0 and tuple(mesh_shape) == (1, 1):
        for T in SPARSE_TILE_CANDIDATES:
            plan = {"sparse_tile": T}
            if _feasible(config, mesh_shape, plan):
                out.append(Candidate(plan, f"sparse_tile={T}"))
    out.extend(_block_candidates(config, mesh_shape, device=device))
    if deepest_k is not None:
        # the (k, blocks) plane: tiles re-screened at the deepest feasible
        # depth, where the kernel may differ (K3 gives way to K2 past
        # ⌊8/r⌋, whose tiles are screened at that pass depth) and the
        # default tile does
        out.extend(
            c for c in _block_candidates(config, mesh_shape, gens=deepest_k,
                                         device=device)
            if _feasible(config, mesh_shape, c.plan)
        )
    if include_batch:
        for B in (2, 4, 8):
            out.append(Candidate({"batch": B}, f"batch={B}"))
    return out
