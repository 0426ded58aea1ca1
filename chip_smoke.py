#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``mpi_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout, one card

Phases; any failure exits non-zero before the result line:

0. the card: name and power limit from ``nvidia-smi``; no CUDA, no run;
1. build kernel K2 (``mpi_tpu_torch/csrc/stencil.cu``) with nvcc into the
   common library, and K1 and K3 once per rule, in parallel nvcc processes
   (K1 for every rule of phase 2, K3 one library for each radius 2..7);
   report each kernel's registers and spills (ptxas; none may spill), K1's
   tile and the CTAs that share an SM at each depth, and count the
   instructions of K1's, K2's and K3's row loops in the built SASS
   (``cuobjdump``), per word-generation (K1, K3) and per cell-generation
   (K2); then time the common build and one per-rule build of each kernel
   alone, twice each;
2. each kernel against its plain PyTorch version, exact (``torch.equal``):
   K1 over gens x boundaries x rules x ragged shapes and random rules,
   every depth 1..16, shapes around its tile's edges (1, 2, 29-33, 61-65
   and 119-129 words a row; 1-3 and 127-130 rows), grids that cross the
   torus seam in both axes, dead grids larger than two tiles each way
   (edge and interior CTAs, aligned and unaligned rows), and at 65536² at
   the main path's depths; K2 over radii 1, 2, 3, 5, 7 x
   depths with gens x r <= 16 x boundaries x ragged widths (grids below the
   neighbourhood too, a birth-on-0 rule, random rules), and at 16384²
   (Bosco, gens 1 and 3); K3 over radii 2..7 x gens 1..⌊8/r⌋ x boundaries
   x ragged shapes (one word per row, small H, random rules), and at 65536²
   (Bosco gens 1, R2 gens 4), its distinct rules built first, together.
   The modes this slice added: K1 and K3 with ``col_limit`` (pads of 1, 24
   and 31 bits at 1, 2, 31 or 127-130 words a row, a ghost word over the
   pad, every depth, both boundaries, and 65000² at the padded paths'
   depths), K1-K3 on a board axis (1, 2, 7 and 32 boards, ragged rows and
   words, rows that do and do not move in 16-byte pieces, padded boards;
   each batch one launch), and the seam band's one launch
   (``seam.fused_band``) against its three plain pieces, alone and in
   whole padded passes; and K1, K3 and K2 at a dead
   boundary and gens 1 on the stripes of sparse stepping (the tiles of a
   rung side by side with their halos: the plans of the sparse paths and
   CLI cases below, and narrow ones);
3. the main paths, each kernel's launch counter reset just before and
   required above 0 just after, each whole final grid equal to the plain
   version's from the same init: ``run_cuda`` at 65536² for Life (comm_every
   8, K1), for Bosco (comm_every 1, K3) and for R2,B10-13,S8-12 (comm_every
   4, K3), at 16384² for Bosco (comm_every 3, K2), at 65000² (a width of
   2031.25 words) for Life (periodic, comm_every 8: K1 with ``col_limit``
   and the seam band) and Bosco (dead, comm_every 1: K3 with
   ``col_limit``), and ``step_batched`` on 32 boards of 4096² (Life,
   comm_every 8, one K1 launch a pass, then depth-1 ``step_batched_units``),
   each ~250-280 ms of stepping, so that a stray delay of 2 ms on the
   machine stays under 1% of the window; 16384² Bosco at comm_every 4 (20
   cells of halo: K2 in passes of 3), whose final grid must equal the
   comm_every-3 path's; and the sparse Life engine (``sparse_tile`` 128)
   at 65536² on the reference's quiescent board with 64 gliders, 2001
   generations, held against the dense K1 engine and the plain version,
   and on the reference's 35% soup, 200 generations, held against the
   dense K1 engine.  Then the CLI at 512² (Life at comm_every 4 and
   Bosco, both boundaries; Bosco at comm_every 4 on K2; Life with
   ``--sparse 32``), at 500x500 (Life at comm_every 3 and Bosco at 1 on
   the padded K1 and K3, with the seam band when periodic; Bosco at 2 on
   K2) and at 480x500 (Bosco with ``--sparse 20`` on K2), whose ``.gol``
   files must equal the serial oracle's byte for byte;
4. times (CUDA events after warm-up) of each kernel at its main paths'
   depths, with cell-updates/s, the plain version's time, the card's bound,
   and a library call where one exists (for K2, ``conv2d`` of the padded
   grid in float16: the counts only); K1's kept design against its
   variants (the rule from run-time masks, which the kernel evaluated
   before the rule was compiled in; words per lane; ghost words; rows per
   CTA; the tile load; the kernel without the padded-grid code) at gens 8,
   4, 2 and 1, in turns, each variant's output equal to the kept one's;
   K3's run lengths (rows a warp steps) at every radius's gens 1 and
   deepest pass, in turns; the padded paths' passes (K1 or K3 with
   ``col_limit``, the whole seam pass with the band's one launch, the
   band alone in one launch and on ``evolve_band``, and the same grids
   forced onto K2), in turns; and a pass over a
   batch in one launch against its boards in one launch each (K1, K3,
   K2), in turns, in ms per board-generation; the sparse engine against
   the dense K1 engine at comm_every 1 and 8 on the sparse paths' boards,
   in turns, in ms a generation, and K1's stripe step against its bound;
5. a ``torch.profiler`` trace of each main path's steady stepping: kernel
   time by name, launches equal to the trace's kernels of the path's
   kernel (the sparse path's follow its phases), the other kernels' time
   (the seam band; the sparse path's gathers, compares and write-backs),
   the device's idle share of the wall time, and no kernel build inside
   it;
6. the serve layer (``mpi_tpu_torch/serve``) on the card: a
   ``SessionManager`` creates 32 sessions of 4096² Life (comm_every 8; one
   cache miss, 31 hits that warm nothing), and 32 threads step them 8
   generations a request, coalesced into one K1 launch a round, whose
   boards must equal ``step_batched``'s on the same seeds and the plain
   version's; 8 sessions of 4096² Bosco on K3 (comm_every 1) and 8 on K2
   (comm_every 3) step through tickets of mixed depths, equal to the plain
   versions, with a state dir (checkpoint_every 64) from which a second
   manager restores every session bit for bit after the first is shut
   down, both stepping on equal; at 256², a transient injected fault
   retries, an injected delay past the deadline is a ``DeadlineError``
   with the session intact, and a tripped breaker degrades the session to
   the oracle with equal boards, while a real failure of the card's engine
   answers ``EngineUnavailableError`` with the session left on the card;
   8 threads step 8 sessions on one 4096² Life engine solo (no batcher),
   each board equal to the plain version's.  Outside those faults, no batched
   fallback, engine failure or degraded session, and no kernel build
   while serving.  A ``torch.profiler`` window of serving gives the
   device's idle share and the K1 time, which the layer's own step time
   (``batched_step_s``, and each session's ``steady_s`` when every round
   coalesced) must reach: the wait for the device truly waits.  The
   per-layer numbers: board-generations/s of serving against
   ``step_batched`` alone on the same boards, requests/s and the host's
   CPU ms a request;
7. observability on the card and the native backends on its host: 32
   sessions of 4096² Life (K1) and one each of 4096² Bosco on K3 and on K2
   (comm_every 3) on two managers, one without obs and one with a full
   ``Obs`` (telemetry unstarted, flight recorder, anomaly detector,
   device-memory sampler), served the same requests in turns (off, on,
   on, off: requests/s of each), their boards equal bit for bit; every
   engine's cost cards (one per warmed depth and batch, ``source``
   ``kernel_count``, K1's, K3's and K2's equal to their kernels' counts
   times the work) and the card's int32 roof from its properties, printed
   with its name and power limit; ``run_profile`` over about a second of
   the Life traffic, started half a second after the capture's first
   kernel, writes a Chrome trace whose K1 records equal the K1 launches
   counted in it (the trace rule of phases 5 and 6, one retake);
   ``read_device_memory`` reports memory in use; a ``cpp-par`` session
   equals a ``cuda`` session of its spec; and the CLI at 2048² with
   ``--backend cpp`` and ``--backend cpp-par --workers 8`` writes the
   board ``--backend cuda`` writes, read back with ``golio``, with the
   same master header but for ``cpp-par``'s tile count;
8. the network front on the card: the threaded front
   (``serve/httpd.py:make_server``, in process, a full ``Obs`` and a
   profile dir) serving 32 client threads, each on one keep-alive
   connection and one 4096² Life session, 1 + 20 rounds of 8-generation
   steps; K1's launches in the timed window equal the steps plus the
   warm-ups of batch widths met the first time (phase 6's rule); every
   board read back as a binary frame (``serve/wire.py``) equals
   ``step_batched``'s, the first and last the plain version's;
   requests/s, host CPU ms a request and their ratio over phase 6's
   in-process requests/s.  ``GET /metrics`` holds the reference's
   families (``obs/metrics.py:FAMILIES``), ``GET /usage`` equals the
   manager's ``usage()``, and ``POST /debug/profile?secs=2`` under the
   same traffic writes a trace whose K1 records equal the launches
   counted inside the capture (the trace rule, with phase 7's lead and
   first kernel).  Admission: a tenant whose window lies below one
   request's estimate (K1's card over the card's roof) gets 429 with
   ``Retry-After`` and no launch, a roomy one is served.  The aio front
   (``serve/aio.py``): 4 Bosco sessions on K3 and 4 on K2 (comm_every 3),
   4096², tickets of depths 1, 2, 5, 8 read by parked waiters
   (launches = unit rounds + warm-ups), boards equal to the plain
   versions; one ``GET /stream/<sid>?every=1`` of 9 frames, each the
   plain board at its generation.  Then ``python -m mpi_tpu_torch.cli
   serve --state-dir D --checkpoint-every 1`` (no ``--device``: the
   card) steps a 4096² Bosco session on K3 5 times, is SIGKILLed, and a
   second process restores generation 5 and steps on to the plain board
   at 8;
9. cluster mode on the card: three ``python -m mpi_tpu_torch.cli serve
   --device cuda`` processes on loopback ports, started together as one
   cluster (``--peers``) over one shared ``--state-dir`` with
   ``--checkpoint-every 1`` and the reference's chaos settings (gossip
   every 0.25 s, a peer down after 1.0 s and dead after 2.5 s, telemetry
   every 0.25 s), each printing its wrappers' launch counts as it exits.
   24 sessions of 4096² Life (K1), 4 of Bosco on K3 and 4 on K2 are
   created through the three fronts in turn and placed by the ring; each
   steps 8 generations a request in turns through a front that does not
   hold it (one proxy hop) and through its holder: proxied against
   direct requests/s and the nodes' CPU ms a hop; every board then comes
   back as a binary frame through both, byte for byte the same and equal
   to the plain version's, and each holder's flight records name the
   session's kernel.  A proxied async step's trace, fetched from the
   third front, is one tree of two processes' spans; every front's
   ``/usage`` ``cluster.totals`` converges to the exact sum of the three
   ledgers, ``/slo`` names all three nodes, ``/metrics`` carries the
   ``host``/``process`` labels and the cluster families.  The node that
   holds the most sessions is SIGKILLed (after a ticket on one of its
   sessions): each survivor confirms it dead, its sessions are adopted
   from the state dir by replay on the card (``failover_lost`` 0) and
   answer byte for byte as before the kill (a 503 in the window must
   carry ``Retry-After``), its ticket answers the structured 404, and
   each orphan steps on, its adopter's flight record naming its kernel.
   ``POST /cluster/drain`` on one survivor hands every session to the
   other with no generation lost; every board steps on equal to the
   plain version's.  The survivors' launch counts must hold K1, K2 and
   K3.  Last, ``python -m mpi_tpu_torch.serve.scrub`` verifies the state
   dir, repairs what the SIGKILL tore and verifies it clean;
10. the plan tuner (``mpi_tpu_torch/tune``) on the card: every CTA tile
   ``tune.candidates`` proposes for Life, Bosco and R2,B10-13,S8-12 at
   2048² and 4096², the paired (comm_every, blocks) plane included, and
   for Bosco at comm_every 3 (K1 ``[rows, words a lane]``, K3 ``[rows]``,
   K2 ``[rows, cols]``, and K2's larger tiles 256x256, 128x512 and
   512x128, which the tuner's cap leaves out), built in one call per
   kernel (``build_rules`` for K1 and K3, ``build_variants`` for K2's
   variants of the common library, beside the others; each K2 variant's
   registers and spills) and held against the plain version
   exactly (both boundaries
   at gens 1 and the deepest depth; K1 and K3 on a ragged grid, a batch
   and a padded grid; K2 on a 16-aligned 2048² grid, ragged widths below
   and above the tile's narrow threshold, and a batch); each tile timed
   against the default build in turns at 2048² and 65536² (K2: 2048² and
   16384² Bosco at gens 3 and 1), with its bound; ``tune_plan`` over the
   reference's tuning regime (2048² Life, one blinker in ~1% of the 128²
   tiles, 200 generations after 32, best of 2), every measured probe's
   board equal to the default plan's; the cache reloaded from disk by a
   fresh ``SessionManager(tune_cache=...)`` (the best measured candidate
   written in when the default won), whose first session's engine holds
   the plan, whose second same-spec session compiles nothing, both
   boards equal to the default plan's and the plain version's; the same
   for 2048² Bosco at comm_every 3 with the fastest K2 tile written in,
   every K2 launch of its sessions on that variant's library; and
   ``python -m mpi_tpu_torch.cli 4096 4096 0 64 --profile DIR`` on the
   card, whose Chrome trace holds K1 records equal to the K1 launches the
   process counted (the trace rule, one retake).  The speedup is printed,
   not judged;
11. static analysis (``mpi_tpu_torch/analysis``) on the card: ``python -m
   mpi_tpu_torch.analysis`` as a subprocess must exit 0 (no finding, no
   unused suppression); the launch-level verifier's whole matrix
   (``analysis/ir``: 34 cells of 64 rows, 21 of them on meshes of virtual
   shards of the card, two recorded steps each, the steps without sparse
   stepping under ``set_sync_debug_mode("error")``, the mesh cells' halo
   exchanges held to ``ir-collective``) runs on the card with zero
   findings, each cell's fingerprint the one
   blessed on the CPU in ``analysis/ir/baseline.json``, K1, K2 and K3
   each launched by their wrappers' counters, and each cell's boards
   after one step and after two equal to the same cell's on the CPU (the
   plain versions); and one seeded fault, the seam stepper that takes its
   band from the pass's input after the kernel launch, must be flagged
   by ``ir-donation`` on the card;
12. the single-process mesh (``parallel/``, ``backends/cuda_mesh.py``)
   on virtual shards of the one card (``make_mesh(shape,
   devices=[cuda:0] * n)``): ``build_engine`` with the mesh at the
   flagship's width for Life (65536², 2x2, comm_every 8, 1500
   generations) with and without ``overlap`` (K1 interiors), Bosco
   (65536², 1x2, comm_every 1, 200; K3), dense Bosco (16384², 2x2,
   comm_every 7, 1201: K·r = 35 is past one ghost word, so K2 in chunks
   of 3; at comm_every 3 a mesh takes K3, as the reference's does) and
   padded periodic Life (65000², 1x2,
   comm_every 8, 1500; K1 with a local ``col_limit`` and the seam band
   across the shard columns in one launch a pass).  Each path's launch
   counts, read just after its steps with the counters reset just before
   its build, must equal shards x passes x windows (five with the overlap
   body) in the kernel's chunks plus its warm-ups, and one seam launch a
   pass and a warm-up a pass depth, no K2; its whole final grid, gathered on
   the card, must equal phase 3's single-device final of the same config
   (SHA-256 of the grid's bytes, and the population); its steady seconds
   and cell-updates/s print beside the 1x1 path's, and one
   ``torch.profiler`` window of four passes gives the exchange's copies'
   device ms and the idle share.  Then the CLI: ``--mesh 1x1`` on the
   card equal to the serial oracle, ``--mesh 2x2`` on the one card
   refused with the reference's message before any file is written, and
   ``--mesh 2x2 --device cpu --save`` whose every tile equals the serial
   oracle's.  Phase 2 holds K1-K3 at these paths' shard windows (dead
   boundary, the padded shard's local ``col_limit``, the Life overlap
   bands, the dense path's 16-aligned windows at gens 3 and 1) to their
   plain versions.  Life also runs 1x2 there, phase 13's mesh in one
   process;
13. the multi-process mesh (``parallel/dist.py``, the CLI's
   ``--multihost``) on the one card: after the libraries its groups load
   are built here (no rank runs nvcc), groups of ``python -m
   mpi_tpu_torch.cli ... --multihost --coordinator 127.0.0.1:PORT
   --device cuda`` processes, one shard a rank, at full width: Life
   65536² on 1x2 (2 ranks, comm_every 8, 1500 generations; K1), Bosco
   65536² on 1x2 (2 ranks, comm_every 1, 200; K3), dense Bosco 16384² on
   2x2 (4 ranks, comm_every 7, 1201; K2 in chunks of 3, 3, 1) and padded
   periodic Life 65000² on 1x2 (2 ranks; K1 with a local ``col_limit``,
   the seam band gathered across the ranks onto the owner of shard (0,
   1) and stepped there in one launch), each with ``--save``: every rank's
   transport line must say ``gloo-host-staged``, its launch counts
   (printed by each rank as it exits) must equal ``_mesh_expected`` for
   its one shard, and its final ``.golp`` tiles, region by region, must
   equal phase 3's single-device final of that config (SHA-256 of each
   tile's body and its population, read off the device final by phase
   3; no whole grid unpacked on the host); the files go after the
   check.  Life and Bosco run again without ``--save``: their rates from
   the CSV row, whose avg and sum columns are the ranks' gathered
   durations, against the 1x1 path's and phase 12's one-process rate of
   the same mesh, with each rank's bytes staged through the host, its
   seconds in stream syncs and in waits; Life once more with
   ``--profile`` (one trace a rank): the card's busy share of the steady
   window.  Then the CLI's small groups against the serial oracle: 512²
   Life on 4 ranks (the default mesh, 2x2), R2 at 256x1024 written on
   1x4 and resumed on 2x2 (4 ranks), and ``--comm-every auto`` on 2
   ranks, whose ranks must resolve one K.  A rank that exits non-zero, or
   a group that outlasts its limit, kills every rank of the group and
   fails the script;
14. serving and tuning on a mesh of virtual shards of the one card (a
   ``SessionManager`` given ``devices=[cuda:0] * n``): phase 6's 32
   sessions of 4096² Life on 2x2, 1 + 20 rounds of 8 generations from 32
   threads, each coalesced round one K1 launch a shard (four) for all 32
   boards, every board equal to ``step_batched``'s of the same seeds on
   one device, requests/s over phase 6's 1x1 rate and one profiled
   window's idle share; a 16384² Life session on 2x2 beside the same
   session on 1x1: 1024² viewports across the shard seams (rows and
   columns 8192) and across the periodic wrap, one transfer a shard a
   viewport meets, a region write across a seam, a windowed delta stream
   over the aio front folded frame by frame against the keyframe stream,
   and the shard-form checkpoint restored onto 2x2 and onto 1x1, every
   read and board equal to 1x1's; 4096² Bosco on 1x2 (K3) and dense
   Bosco on 2x2 at comm_every 7 (K2) through tickets of depths 1, 2, 5
   and 8, equal to 1x1's; padded periodic 4096 x 4090 sessions on 1x2,
   Life at comm_every 8 and Bosco at 4 (20 cells of seam band, past K2's
   16), each step's launches the shards' windows and one seam launch a
   pass, boards equal to 1x1's; the tuner at 4096² Life on
   2x2 over three candidates, every probe exact, the winner through the
   halo-slab bless, applied by a fresh manager's cache (a second session
   compiles nothing, the grid equal to the untuned one's); the devmem
   sampler's halo probe on the serving mesh; and each batched shard
   window these paths launch timed against its plain version and bound.
   Phase 2 holds K1-K3 at those batched windows to their plain versions,
   and the seam band's one launch at every depth to 31.

It prints JSON lines, the ``{"kernels": [...]}`` line second to last, and
as its last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import filecmp
import hashlib
import io
import http.client
import json
import os
import queue
import re
import socket
import subprocess
import sys
import shutil
import signal
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from mpi_tpu_torch import golio, tune  # noqa: E402
from mpi_tpu_torch.admission import AdmissionControl  # noqa: E402
from mpi_tpu_torch.admission.tenants import normalize_tenants  # noqa: E402
from mpi_tpu_torch.analysis import ir  # noqa: E402
from mpi_tpu_torch.analysis.ir import checks as ir_checks  # noqa: E402
from mpi_tpu_torch.analysis.ir.faults import late_band_seam  # noqa: E402
from mpi_tpu_torch.analysis.ir.harness import record_engine  # noqa: E402
from mpi_tpu_torch.analysis.ir.matrix import cell_by_id  # noqa: E402
from mpi_tpu_torch.backends import cuda as backend  # noqa: E402
from mpi_tpu_torch.backends.cuda_mesh import chunk_gens  # noqa: E402
from mpi_tpu_torch.backends.cpp import plan_tiles  # noqa: E402
from mpi_tpu_torch.backends.serial_np import evolve_np  # noqa: E402
from mpi_tpu_torch.cli import main as cli_main  # noqa: E402
from mpi_tpu_torch.config import WORD, GolConfig, apply_plan  # noqa: E402
from mpi_tpu_torch.interop import grid_from_numpy  # noqa: E402
from mpi_tpu_torch.models.rules import (  # noqa: E402
    BOSCO, DAY_AND_NIGHT, HIGHLIFE, LIFE, SEEDS, Rule, rule_from_name,
)
from mpi_tpu_torch.obs import Obs  # noqa: E402
from mpi_tpu_torch.obs.cost import (  # noqa: E402
    device_roof_ops_per_s, ops_per_cell_estimate, roof_ops_per_s,
)
from mpi_tpu_torch.obs.devmem import read_device_memory  # noqa: E402
from mpi_tpu_torch.obs.metrics import FAMILIES  # noqa: E402
from mpi_tpu_torch.obs.profile import capturing, run_profile  # noqa: E402
from mpi_tpu_torch.ops import _build, _launch, activity  # noqa: E402
from mpi_tpu_torch.ops.bitlife import (  # noqa: E402
    bit_step, init_packed, mask_pad, pack, pad_mask, population, unpack,
    word_ops,
)
from mpi_tpu_torch.ops.bitltl import (  # noqa: E402
    ltl_step, ltl_word_ops, ltl_word_ops_lower,
)
from mpi_tpu_torch.ops.cuda_bitlife import (  # noqa: E402
    bit_step_plain, cuda_bit_step,
)
from mpi_tpu_torch.ops.cuda_bitlife import launch as bit_launch  # noqa: E402
from mpi_tpu_torch.ops.cuda_bitltl import (  # noqa: E402
    cuda_ltl_step, ltl_step_plain, max_gens,
)
from mpi_tpu_torch.ops.cuda_bitltl import (  # noqa: E402
    BLOCK_ROWS as BLOCK_ROWS_K3, DEFAULT_ROWS as K3_DEFAULT_ROWS,
)
from mpi_tpu_torch.ops.cuda_bitltl import launch as ltl_launch  # noqa: E402
from mpi_tpu_torch.ops.ltl_codegen import (  # noqa: E402
    lop3_count, rule_key, rule_program,
)
from mpi_tpu_torch.ops.cuda_stencil import (  # noqa: E402
    cuda_dense_step, dense_step_plain, rule_table,
)
from mpi_tpu_torch.ops.stencil import (  # noqa: E402
    counts_from_padded, dense_cell_ops, pad_grid,
)
from mpi_tpu_torch.parallel import seam  # noqa: E402
from mpi_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from mpi_tpu_torch.serve import (  # noqa: E402
    DeadlineError, EngineCache, EngineUnavailableError, SessionManager,
    recovery, wire,
)
from mpi_tpu_torch.serve.aio import make_aio_server  # noqa: E402
from mpi_tpu_torch.serve.httpd import make_server  # noqa: E402
from mpi_tpu_torch.utils.hashinit import init_dense, init_tile_np  # noqa: E402
from mpi_tpu_torch.utils.segmenting import segmented_evolve  # noqa: E402
from mpi_tpu_torch.utils.timing import PhaseTimer  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA's data sheet): 3.35 TB/s of
# HBM, and 67 TFLOP/s float32 outside the tensor cores, which is 132 SMs x
# 128 lanes x 2 (an FMA) x 1.98 GHz.  A Hopper SM has 64 int32 lanes, so
# the int32 rate is a quarter of that figure, in instructions per second.
# K1's and K3's work is counted in those instructions (LOP3 and SHF):
# ``word_ops`` exactly for K1's compiled form; ``ltl_word_ops_lower`` and
# ``ltl_word_ops`` from below and above for K3's function, the bound
# taking the lower count.  K2's least work: sliding window sums need about 6 per
# cell-generation whatever r is (a three-input add to slide each of the
# vertical and horizontal windows, the centre, the rule's test, the
# result), and every sum fits a byte (<= 225), so four cells share one
# 32-bit instruction.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
K2_CELL_OPS = 6 / 4

SEED = 1
FLAGSHIP = 65536         # K1 and K3 main paths: 512 MiB packed
PADDED = 65000           # the padded paths: 2032 words a row, 24 bits pad
PADDED_WORDS = -(-PADDED // 32)
MAIN_GENS = 8            # K1's main path: comm_every 8
MAIN_STEPS = 1500        # 187 passes of 8 and a remainder pass of 4
MAIN_DEPTHS = (1, MAIN_STEPS % MAIN_GENS, MAIN_GENS)  # warm-up, remainder, K
R2 = rule_from_name("R2,B10-13,S8-12")
# (label, rule, comm_every, steps) of K3's main paths at 65536²
LTL_PATHS = (("bosco", BOSCO, 1, 200), ("r2", R2, 4, 450))
DENSE = 16384            # K2's main path: 256 MiB of cells
DENSE_PATH = ("bosco", BOSCO, 3, 1201)
# (label, kernel, engine, rule, comm_every, steps, boundary) at PADDED²:
# K1 with the seam band, K3 padded on a dead grid
PADDED_PATHS = (("padded_life", "K1", "bit", LIFE, 8, 1500, "periodic"),
                ("padded_bosco", "K3", "ltl", BOSCO, 1, 200, "dead"))
# (rows, steps) of a strip of the padded Life path at its full width, held
# against the plain dense step on the real width (no seam code): 12 passes
# of 8 and one of 4, as the path's last
SEAM_STRIP = (1024, 100)
# (label, boards, size, rule, comm_every, steps, depth-1 units after):
# 2 MiB a board, 64 MiB a batch buffer, above the H100's 50 MB of L2
BATCH_PATH = ("batched_life", 32, 4096, LIFE, 8, 6000, 100)

# the sparse Life path at FLAGSHIP² on SPARSE_T² tiles (512 x 512): the
# reference's quiescent board (bench.py:2018-2034: one blinker in each of
# 1% of the tiles, packed into a square block) plus SPARSE_GLIDERS gliders,
# some of which cross the periodic seam; an odd number of generations (one
# that settles the all-ones start, then the rest in one dispatch), so that a
# stepper that did nothing fails against the period-2 blinkers
SPARSE_T = 128
SPARSE_ACTIVE = 0.01
SPARSE_GLIDERS = 64
SPARSE_STEPS = 2001
# the reference's soup (bench.py:2040): 35% live, every tile busy
SOUP = (0.35, 200)
SPARSE_TIMED = 400     # generations a timed dispatch (50 gathers of 8)
# 16384² Bosco at comm_every 4: 20 cells of halo, K2 in passes of 3, whose
# final grid must equal DENSE_PATH's (comm_every 3)
DEEP_PATH = ("deep_bosco", BOSCO, 4, 1201)
GLIDER = ((0, 1, 0), (0, 0, 1), (1, 1, 1))  # moves down and right

# each kernel's wrapper, whose ``launches`` the main paths read
KERNELS = {kid: wrapper for kid, wrapper, _ in backend.KERNELS.values()}
# and the seam band's one launch, which the padded paths count beside them
COUNTERS = dict(KERNELS, seam=seam.fused_band)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase0_card() -> str:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})
    return card


def _spills(resources) -> list:
    return [r for r in resources if r.get("spill_stores") or
            r.get("spill_loads")]


def phase1_build() -> None:
    t0 = time.perf_counter()
    lib = _build.load_library()
    seconds = time.perf_counter() - t0
    resources = _build.kernel_resources(_build.library_path())
    k1_rules = list({rule_key(c[1]): c[1] for c in _k1_cases()}.values())
    t0 = time.perf_counter()
    k1_libs = _build.build_rules("bit", k1_rules)
    k1_seconds = time.perf_counter() - t0
    k1_resources = {rule_key(r): _build.kernel_resources(p)
                    for r, p in zip(k1_rules, k1_libs)}
    t0 = time.perf_counter()
    ltl_libs = _build.build_rules("ltl", list(LTL_RULES.values()))
    ltl_seconds = time.perf_counter() - t0
    ltl_resources = {r: _build.kernel_resources(p)
                     for r, p in zip(LTL_RULES, ltl_libs)}
    k1 = _build.load_rule_library("bit", LIFE)
    words_per_lane, owned_words = ctypes.c_int(), ctypes.c_int()
    rows = {g: k1.gol_bit_tile(g, ctypes.byref(words_per_lane),
                               ctypes.byref(owned_words))
            for g in (1, 4, 8, 16)}
    words_per_lane, owned_words = words_per_lane.value, owned_words.value
    registers = sorted({v[0].get("registers") for v in k1_resources.values()
                        if v})
    emit({"phase": "build", "kernels": ["K1", "K2", "K3"],
          "sources": [p.name for p in _build.sources()], "seconds": seconds,
          "library": os.path.relpath(lib._name, ROOT),
          "ptxas": resources,
          "k1_rules": len(k1_rules),
          "k1_parallel_build_seconds": k1_seconds,
          "k1_tile": {"words_per_lane": words_per_lane,
                      "owned_words": owned_words, "rows_by_gens": rows},
          "k1_ctas_per_sm": {g: k1.gol_bit_ctas_per_sm(g)
                             for g in (1, 4, 8, 16)},
          "k1_registers": registers,
          "k1_ptxas_life": k1_resources[rule_key(LIFE)],
          "k3_rules": {r: rule_key(rule) for r, rule in LTL_RULES.items()},
          "k3_parallel_build_seconds": ltl_seconds,
          "k3_ptxas": ltl_resources})
    # K2 at r 1..7 in the common library (for full grids and for grids
    # narrower than a tile) and the seam band's kernel at r 1..7, one kernel
    # in each library of K1 (one per rule) and of K3 (r 2..7)
    # (K3 has one instance a depth, ltl_step_kernel<gens>)
    per_rule = list(k1_resources.values()) + list(ltl_resources.values())
    k3_kernels = {r: max_gens(r) for r in ltl_resources}
    if (len(resources) != 21 or any(len(v) != 1 for v in k1_resources.values())
            or any(len(v) != k3_kernels[r] for r, v in ltl_resources.items())):
        fail(f"expected 21 kernels in the common library, one in each K1 "
             f"library and {k3_kernels} in the K3 ones, got {resources}, "
             f"{k1_resources} and {ltl_resources}")
    spilled = _spills(resources + sum(per_rule, []))
    if spilled:
        fail(f"kernels spill: {spilled}")
    _sass_loops(lib._name, k1._name, words_per_lane,
                str(ltl_libs[list(LTL_RULES).index(5)]))
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        emit({"phase": "build_seconds", **_build_seconds(Path(d))})


def _build_seconds(d: Path) -> dict:
    """Seconds to build, into fresh directories under ``d``, twice each:
    the common library, one K1 library (Life) alone, and one K3 library
    (Bosco) alone."""
    out = {"common": [], "k1_one_rule": [], "k3_one_rule": []}
    home = _build.BUILD_DIR
    try:
        for rep in range(2):
            t0 = time.perf_counter()
            _build.build(d / f"common{rep}.so")
            out["common"].append(time.perf_counter() - t0)
            for key, kind, rule in (("k1_one_rule", "bit", LIFE),
                                    ("k3_one_rule", "ltl", BOSCO)):
                _build.BUILD_DIR = d / f"{kind}{rep}"
                t0 = time.perf_counter()
                _build.build_rules(kind, [rule])
                out[key].append(time.perf_counter() - t0)
    finally:
        _build.BUILD_DIR = home
    return out


def _sass_functions(library: str) -> dict:
    """Each kernel's SASS in the built library, by its short name (e.g.
    ``ltl_step_kernel<5>``): a list of (address, opcode, backward-branch
    target or None)."""
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    dump = subprocess.run([tool, "-sass", library], capture_output=True,
                          text=True, timeout=300)
    if dump.returncode != 0:
        fail(f"cuobjdump failed: {dump.stderr.strip()}")
    out = {}
    for f in dump.stdout.split("Function : ")[1:]:
        k = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)E)?", f.splitlines()[0])
        if not k:
            continue
        code = []
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                             r"([A-Z][A-Z0-9_.]*)([^;]*);", f):
            addr, op = int(m[1], 16), m[2]
            t = re.search(r"0x([0-9a-f]+)\s*$", m[3]) if op == "BRA" else None
            code.append((addr, op, int(t[1], 16)
                         if t and int(t[1], 16) < addr else None))
        out[k[1] + (f"<{k[2]}>" if k[2] else "")] = code
    return out


def _inner_loops(code) -> list:
    """The bodies of the innermost loops (a backward branch with no other
    inside it), as lists of opcodes."""
    loops = []
    for end, _, start in code:
        if start is None:
            continue
        body = [(a, op, b) for a, op, b in code if start <= a <= end]
        if all(b is None for a, _, b in body if a != end):
            loops.append([op.split(".")[0] for _, op, _ in body])
    return loops


def _row_loop(code, mark: str, marker: str) -> dict:
    """The innermost loop of ``code`` with the most ``mark`` opcodes, which
    in K2 (PRMT) and K3 (SHFL) is the row loop, with the rows it steps per
    iteration: the count of its ``marker`` opcode, which each row issues
    once."""
    body = max(_inner_loops(code), key=lambda b: b.count(mark), default=[])
    rows = body.count(marker)
    if not body.count(mark) or not rows:
        fail(f"no row loop with {mark} and {marker} found in the SASS; "
             f"innermost loops: {[Counter(b).most_common(6) for b in _inner_loops(code)]}")
    return {"instructions": len(body), "rows_per_iteration": rows,
            "by_opcode": dict(Counter(body).most_common(10)),
            "opcodes": dict(Counter(body))}


def _sass_loops(library: str, k1_library: str, k1_words_per_lane: int,
                ltl_library: str) -> None:
    """Instructions per unit of work as the card runs them, counted
    statically in the innermost loops of the built SASS (a store that a
    predicate skips still counts).

    K1 for Life: every innermost loop that shuffles is a row loop; each
    row it steps loads the lane's words once from shared memory (one LDS),
    so its LDS count is its rows per iteration, whatever the unrolling,
    the shuffles per row or the words per lane.  The loops that store to
    shared memory are the in-tile generations, masked and bare; the one
    that stores to device memory (STG) is the last generation.  K2 at
    r = 5: the row loop steps 16 cells (four words) of one thread per row,
    one STS each.  K3 for Bosco: the row loop steps one word of one lane
    per row, one STG each (a predicate picks it or the shared store)."""
    k1 = []
    k1_code = _sass_functions(k1_library).get("bit_step_kernel", [])
    for body in _inner_loops(k1_code):
        rows = body.count("LDS")
        if body.count("SHFL") and rows:
            words = rows * k1_words_per_lane
            k1.append({"rows_per_iteration": rows,
                       "words_per_iteration": words,
                       "stores_to_device": "STG" in body,
                       "instructions_per_word": len(body) / words,
                       "lop3_shf_per_word":
                           (body.count("LOP3") + body.count("SHF")) / words,
                       "by_opcode_per_word": {
                           k: v / words
                           for k, v in Counter(body).most_common()}})
    in_tile = [loop for loop in k1 if not loop["stores_to_device"]]
    if not in_tile or len(in_tile) == len(k1):
        fail(f"K1's row loops (in-tile and last generation) not found in "
             f"its SASS; innermost loops: "
             f"{[Counter(b).most_common(6) for b in _inner_loops(k1_code)]}")
    steady = min(in_tile, key=lambda loop: loop["instructions_per_word"])
    emit({"phase": "sass", "kernel": "K1", "function": "bit_step_kernel",
          "rule": rule_key(LIFE), "row_loops": k1,
          "instructions_per_word_generation": steady["instructions_per_word"],
          "lop3_shf_per_word_generation": steady["lop3_shf_per_word"],
          "compiled_form_word_ops": word_ops(LIFE)})
    funcs = _sass_functions(library)
    if "dense_step_kernel<5>" not in funcs:
        fail("dense_step_kernel<5> not found in the SASS")
    k2 = _row_loop(funcs["dense_step_kernel<5>"], "PRMT", "STS")
    k2.pop("opcodes")
    emit({"phase": "sass", "kernel": "K2", "function": "dense_step_kernel<5>",
          "row_loop": k2, "instructions_per_cell_generation":
              k2["instructions"] / (16 * k2["rows_per_iteration"])})
    k3_funcs = _sass_functions(ltl_library)
    # the row-first form's instance at gens 1, Bosco's only depth
    name = "ltl_step_kernel<1>"
    if name not in k3_funcs:
        fail(f"{name} not found in {ltl_library}: {list(k3_funcs)}")
    k3 = _row_loop(k3_funcs[name], "SHFL", "STG")
    rows = k3["rows_per_iteration"]
    per_row = {op: n / rows for op, n in k3.pop("opcodes").items()}
    prog = rule_program(BOSCO)
    out = {"instructions_per_word_generation": k3["instructions"] / rows,
           "lop3_shf_per_word_generation":
               per_row.get("LOP3", 0) + per_row.get("SHF", 0),
           "shfl_per_word_generation": per_row.get("SHFL", 0)}
    emit({"phase": "sass", "kernel": "K3", "function": name,
          "rule": rule_key(BOSCO), "row_loop": k3, **out,
          "by_opcode_per_word_generation": per_row,
          "compiled_form_word_ops": ltl_word_ops(BOSCO, "row_first"),
          "rule_gates": len(prog.ops), "rule_lop3": lop3_count(prog)})
    # the row loop's budget: at most 110 instructions and 2 shuffles a
    # word-generation (it shuffles only the row words)
    if (out["instructions_per_word_generation"] > 110
            or out["shfl_per_word_generation"] > 2):
        fail(f"K3's row loop for Bosco is over its budget of 110 "
             f"instructions and 2 SHFL a word-generation: {out}")


# -- phase 2: each kernel against its plain version -------------------------

def _compare(kernel, plain, x, rule, boundary, gens, **kw) -> int:
    """The largest |kernel - plain| over the cells, which are 0 or 1: 0
    when ``torch.equal`` holds, else 1 (and the case is named).  ``kw``:
    ``col_limit`` for K1 and K3."""
    got = kernel(x, rule, boundary, gens, **kw)
    want = plain(x, rule, boundary, gens, **kw)
    if torch.equal(got, want):
        return 0
    bad = int((got != want).sum().item())
    print(f"chip_smoke: {kernel.__name__} != plain: {tuple(x.shape)} "
          f"{rule.name} r={rule.radius} {boundary} gens={gens} {kw}: {bad} "
          f"elements differ", file=sys.stderr, flush=True)
    return 1


def _random_rule(rng, radius: int) -> Rule:
    n = (2 * radius + 1) ** 2
    birth = np.flatnonzero(rng.random(n) < 0.3)
    survive = np.flatnonzero(rng.random(n) < 0.4)
    return Rule("fuzz", frozenset(birth[birth > 0].tolist()),
                frozenset(survive.tolist()), radius)


def _words(rng, shape):
    return grid_from_numpy(rng.integers(0, 2**32, size=shape, dtype=np.uint32),
                           "cuda")


def _cells(rng, shape):
    return torch.from_numpy(rng.integers(0, 2, size=shape,
                                         dtype=np.uint8)).cuda()


def _k1_cases() -> list:
    """K1's small cases as (shape in rows and words, rule, boundary, gens),
    the same in every call: phase 1 builds their rules together, phase 2
    runs them."""
    rng = np.random.default_rng(SEED + 1)
    b0 = rule_from_name("B0/S8")
    both = ("periodic", "dead")
    cases = []
    for shape in [(1000, 96), (7, 33), (2048, 128), (1, 1), (130, 31)]:
        for rule in (LIFE, HIGHLIFE, SEEDS, DAY_AND_NIGHT, b0):
            for boundary in both:
                for gens in ([1] if 0 in rule.birth else [1, 2, 8, 9, 16]):
                    cases.append((shape, rule, boundary, gens))
    for _ in range(60):  # random rules, shapes, depths and boundaries
        birth, survive = (int(v) for v in rng.integers(0, 512, size=2))
        rule = Rule("fuzz", frozenset(c for c in range(9) if birth >> c & 1),
                    frozenset(c for c in range(9) if survive >> c & 1))
        gens = 1 if 0 in rule.birth else int(rng.integers(1, 17))
        shape = (int(rng.integers(1, 300)), int(rng.integers(1, 70)))
        cases.append((shape, rule, both[int(rng.integers(0, 2))], gens))
    # every depth, on a grid of two tile rows of CTAs whose last is ragged
    for gens in range(1, 17):
        for boundary in both:
            cases.append(((200, 130), LIFE, boundary, gens))
    # words a row around the tile's edges (a CTA writes 120 of its 128),
    # where rows stop being 16-byte aligned, and very narrow grids; rows
    # around one tile's 128: each wraps the torus seam inside one tile
    widths = [1, 2, *range(29, 34), *range(61, 66), *range(119, 130), 240, 241]
    for i, nw in enumerate(widths):
        rows = (1, 2, 3, 127, 128, 129, 130)[i % 7]
        for boundary in both:
            for gens in (1, 5, 16):
                cases.append(((rows, nw), HIGHLIFE, boundary, gens))
    for rows in (1, 2, 3, 127, 128, 129, 130):
        for boundary in both:
            cases.append(((rows, 7), DAY_AND_NIGHT, boundary, 16))
    # the shallowest passes write 64 rows a CTA
    for rows in (63, 64, 65, 66):
        for boundary in both:
            for gens in (1, 2):
                cases.append(((rows, 127), SEEDS, boundary, gens))
    # larger than two tiles each way: interior CTAs run the bare loop, edge
    # CTAs of a dead grid the masked one; 400 words a row move in 16-byte
    # pieces, 401 and 402 word by word
    for nw in (400, 401, 402):
        for rule in (LIFE, DAY_AND_NIGHT):
            for boundary in both:
                for gens in (1, 3, 8, 16):
                    cases.append(((400, nw), rule, boundary, gens))
    return cases


def _k1_exact(rng) -> tuple:
    cases = _k1_cases()
    err = 0
    for shape, rule, boundary, gens in cases:
        err = max(err, _compare(cuda_bit_step, bit_step_plain,
                                _words(rng, shape), rule, boundary, gens))
    # a view whose rows are not 16-byte aligned goes word by word
    base = _words(rng, (301, 124)).reshape(-1)
    x = base[3:3 + 300 * 124].view(300, 124)
    n = len(cases)
    for boundary in ("periodic", "dead"):
        err = max(err, _compare(cuda_bit_step, bit_step_plain, x, LIFE,
                                boundary, 8))
        n += 1
    x = init_packed(FLAGSHIP, FLAGSHIP, SEED, device="cuda")
    for gens in MAIN_DEPTHS:
        for boundary in ("periodic", "dead"):
            err = max(err, _compare(cuda_bit_step, bit_step_plain, x, LIFE,
                                    boundary, gens))
            n += 1
    del x
    padded = _padded_exact(rng, cuda_bit_step, bit_step_plain,
                           _k1_pad_cases())
    batched = _batched_exact(rng, "K1", cuda_bit_step, bit_step_plain,
                             _k1_batch_cases())
    return n, err, {"padded": padded, "batched": batched}


PAD_BITS = (1, 24, 31)   # pad bits of the last word of a padded row
BATCH = (1, 2, 7, 32)    # boards in one launch


def _k1_pad_cases() -> list:
    """K1 with ``col_limit``: (rows, words, rule, boundary, gens,
    col_limit).  Pads of 1, 24 and 31 bits at 1, 2 and 127-130 words a row
    (at 127 the first CTA's right ghost word is the padded word; on a
    periodic grid every CTA's left ghost of word 0 is), every depth at 1,
    127 and 129 words, and the padded flagship (65000 cells, 2032 words) at
    the main path's depths."""
    rules = (LIFE, SEEDS, DAY_AND_NIGHT, HIGHLIFE)
    cases = []
    for i, nw in enumerate((1, 2, 127, 128, 129, 130)):
        depths = range(1, 17) if nw in (1, 127, 129) else (1, 2, 8, 16)
        for pad in PAD_BITS:
            for boundary in ("periodic", "dead"):
                for gens in depths:
                    rule = rules[(i + gens) % len(rules)]
                    if gens > 1 and 0 in rule.birth:
                        rule = LIFE
                    cases.append((130, nw, rule, boundary, gens,
                                  WORD * nw - pad))
    for gens in MAIN_DEPTHS:
        for boundary in ("periodic", "dead"):
            cases.append((PADDED, PADDED_WORDS, LIFE, boundary, gens, PADDED))
    return cases


def _k1_batch_cases() -> list:
    """K1 on a board axis: (B, rows, words, rule, boundary, gens,
    col_limit).  Rows a multiple of 4 words move in 16-byte pieces (every
    board's base stays aligned), others word by word; ragged rows and
    words, one word a row, padded boards."""
    cases = []
    for B in BATCH:
        for rows, nw in ((70, 128), (129, 131), (33, 4), (5, 1)):
            for boundary in ("periodic", "dead"):
                for gens in (1, 3, 8):
                    cases.append((B, rows, nw, LIFE, boundary, gens, None))
                cases.append((B, rows, nw, HIGHLIFE, boundary, 5,
                              WORD * nw - 24))
    return cases


def _padded_exact(rng, kernel, plain, cases) -> dict:
    err = 0
    for rows, nw, rule, boundary, gens, col_limit in cases:
        x = _words(rng, (rows, nw))
        err = max(err, _compare(kernel, plain, x, rule, boundary, gens,
                                col_limit=col_limit))
    torch.cuda.empty_cache()
    return {"cases": len(cases), "max_abs_err": err}


def _batched_exact(rng, kid, kernel, plain, cases) -> dict:
    """Each batch against the plain version; one launch for the batch."""
    err = 0
    for B, rows, n, rule, boundary, gens, col_limit in cases:
        x = (_words(rng, (B, rows, n)) if kernel is not cuda_dense_step
             else _cells(rng, (B, rows, n)))
        kw = {} if col_limit is None else {"col_limit": col_limit}
        before = kernel.launches
        err = max(err, _compare(kernel, plain, x, rule, boundary, gens, **kw))
        if kernel.launches != before + 1:
            fail(f"{kid} took {kernel.launches - before} launches for a "
                 f"batch of {B}")
    return {"cases": len(cases), "max_abs_err": err}


DENSE_RULES = {1: LIFE, 2: R2, 3: rule_from_name("R3,B20-25,S18-30"),
               5: BOSCO, 7: rule_from_name("R7,B80-100,S75-119")}


def _k2_exact(rng) -> tuple:
    cases = err = 0
    # widths off 32 and 128, and grids below the neighbourhood (periodic
    # wraps count cells more than once)
    shapes = [(300, 333), (37, 100), (129, 257), (3, 2), (1, 1)]
    for r, named in DENSE_RULES.items():
        top = 16 // r
        for rule in (named, _random_rule(rng, r)):
            for shape in shapes:
                x = _cells(rng, shape)
                for boundary in ("periodic", "dead"):
                    for gens in sorted({1, 2, top - 1, top} - {0}):
                        err = max(err, _compare(cuda_dense_step,
                                                dense_step_plain, x, rule,
                                                boundary, gens))
                        cases += 1
    b0 = Rule("b0", frozenset({0, 3}), frozenset({2, 3}), 2)
    for shape in [(40, 33), (5, 3)]:
        for boundary in ("periodic", "dead"):
            err = max(err, _compare(cuda_dense_step, dense_step_plain,
                                    _cells(rng, shape), b0, boundary, 1))
            cases += 1
    for _ in range(40):  # random rules, radii, shapes, depths, boundaries
        r = int(rng.integers(1, 8))
        shape = (int(rng.integers(1, 400)), int(rng.integers(1, 400)))
        boundary = ("periodic", "dead")[int(rng.integers(0, 2))]
        err = max(err, _compare(cuda_dense_step, dense_step_plain,
                                _cells(rng, shape), _random_rule(rng, r),
                                boundary, int(rng.integers(1, 16 // r + 1))))
        cases += 1
    x = init_dense(DENSE, DENSE, SEED, device="cuda")
    for gens in (1, DENSE_PATH[2]):
        for boundary in ("periodic", "dead"):
            err = max(err, _compare(cuda_dense_step, dense_step_plain, x,
                                    BOSCO, boundary, gens))
            cases += 1
    del x
    batch = [(B, rows, cols, rule, boundary, gens, None)
             for B in BATCH
             for rows, cols in ((70, 333), (129, 256), (3, 2))
             for boundary in ("periodic", "dead")
             for rule, gens in ((LIFE, 1), (LIFE, 8), (BOSCO, 1), (BOSCO, 3))]
    batched = _batched_exact(rng, "K2", cuda_dense_step, dense_step_plain,
                             batch)
    return cases, err, {"batched": batched}


def _fused_exact(rng) -> dict:
    """The seam band's one launch (``seam.fused_band``) against its plain
    version, the three pieces (``stitch_band`` of ``evolve_band`` of
    ``extract_band``), every word of the output, over random words: every
    radius at every depth d = k r <= 31, widths 4d, one word past it and
    65000, 130 rows, one board and three, and a random rule a radius; and
    phase 14's padded Bosco mesh band (4096 x 4090 on 1x2 at gens 4, 20
    cells deep) on its block of the strip's words at the block's width,
    one board and three.  Then whole passes, the engine's pass (the kernel
    and the one launch) against the kernel and the three pieces composed
    here, bit for bit: padded Life 65000² at gens 8 (K1), padded periodic
    Bosco 65000² at gens 1 (K3), and a batch of 4 padded 4096 x 4090 Life
    boards."""
    cases = []
    for r, rule in [(1, LIFE), *LTL_RULES.items()]:
        for k in range(1, 31 // r + 1):
            d = k * r
            for C in (4 * d, 4 * d + 33, PADDED):
                cases += [(rule, k, C, (130, -(-C // WORD))),
                          (rule, k, C, (3, 130, -(-C // WORD)))]
        k = max(1, 8 // r)
        C = 4 * k * r + 7
        cases.append((_random_rule(rng, r), k, C, (70, -(-C // WORD))))
    rows, cols = MESH_PADDED_SHAPE
    words, width = seam.seam_block(cols, 4 * BOSCO.radius)
    cases += [(BOSCO, 4, width, (rows, len(words))),
              (BOSCO, 4, width, (3, rows, len(words)))]
    err = 0
    for rule, k, C, shape in cases:
        d = k * rule.radius
        x, out = (mask_pad(_words(rng, shape), C) for _ in range(2))
        want = seam.stitch_band(out.clone(), seam.evolve_band(
            seam.extract_band(x, C, d), rule, k), C, d)
        got = seam.fused_band(x, out, rule, C, k)
        if not torch.equal(got, want):
            err = 1
            print(f"chip_smoke: fused band != its plain version: {shape} "
                  f"C={C} {rule.name} k={k}", file=sys.stderr, flush=True)
    out = {"cases": {"cases": len(cases), "max_abs_err": err}}
    for label, rule, k, shape, C, kernel in (
            ("padded_life", LIFE, 8, (PADDED, PADDED_WORDS), PADDED,
             cuda_bit_step),
            ("padded_bosco", BOSCO, 1, (PADDED, PADDED_WORDS), PADDED,
             cuda_ltl_step),
            ("padded_life_4_boards", LIFE, 8, (4, rows, -(-cols // WORD)),
             cols, cuda_bit_step)):
        x = mask_pad(_words(rng, shape), C)
        before = (seam.fused_band.launches, cuda_dense_step.launches)
        got = _seam_pass(rule, C, k, kernel)(x, torch.empty_like(x))[0]
        launched = (seam.fused_band.launches - before[0],
                    cuda_dense_step.launches - before[1])
        d = k * rule.radius
        want = seam.stitch_band(
            kernel(x, rule, "periodic", k, col_limit=C),
            seam.evolve_band(seam.extract_band(x, C, d), rule, k), C, d)
        bad = int((got != want).sum().item())
        if bad or launched != (1, 0):
            print(f"chip_smoke: the fused {label} pass differs from the "
                  f"three pieces in {bad} words (launches {launched})",
                  file=sys.stderr, flush=True)
        out[label] = {"shape": list(shape), "col_limit": C, "gens": k,
                      "fused_launches": launched[0],
                      "max_abs_err": int(bool(bad) or launched != (1, 0))}
        del x, got, want
        torch.cuda.empty_cache()
    return out


LTL_RULES = {2: R2, 3: DENSE_RULES[3], 4: rule_from_name("R4,B30-40,S25-50"),
             5: BOSCO, 6: rule_from_name("R6,B50-70,S40-90"),
             7: DENSE_RULES[7]}


def _k3_exact(rng) -> tuple:
    cases = []  # (grid, rule, boundary, gens)
    # (rows, words): ragged, one word per row, small H
    shapes = [(300, 70), (130, 31), (5, 1), (1, 1), (64, 3)]
    for r, named in LTL_RULES.items():
        for rule in (named, _random_rule(rng, r)):
            for shape in shapes:
                x = _words(rng, shape)
                for boundary in ("periodic", "dead"):
                    for gens in range(1, max_gens(r) + 1):
                        cases.append((x, rule, boundary, gens))
    for _ in range(30):  # random rules, radii, shapes, depths, boundaries
        r = int(rng.integers(2, 8))
        shape = (int(rng.integers(1, 300)), int(rng.integers(1, 70)))
        boundary = ("periodic", "dead")[int(rng.integers(0, 2))]
        cases.append((_words(rng, shape), _random_rule(rng, r), boundary,
                      int(rng.integers(1, max_gens(r) + 1))))
    x = init_packed(FLAGSHIP, FLAGSHIP, SEED, device="cuda")
    for _, rule, gens, _ in LTL_PATHS:
        for boundary in ("periodic", "dead"):
            cases.append((x, rule, boundary, gens))
    # every distinct rule's library, in parallel nvcc processes
    rules = list({rule_key(c[1]): c[1] for c in cases}.values())
    t0 = time.perf_counter()
    libs = _build.build_rules("ltl", rules)
    extra = {"rules": len(rules), "build_seconds": time.perf_counter() - t0}
    spilled = _spills(sum((_build.kernel_resources(p) for p in libs), []))
    if spilled:
        fail(f"K3 libraries spill: {spilled}")
    err = 0
    for x, rule, boundary, gens in cases:
        err = max(err, _compare(cuda_ltl_step, ltl_step_plain, x, rule,
                                boundary, gens))
    n = len(cases)
    del x, cases
    pad = [(70, nw, rule, boundary, gens, WORD * nw - p)
           for nw in (1, 2, 31, 127, 130) for p in PAD_BITS
           for r, rule in LTL_RULES.items()
           for boundary in ("periodic", "dead")
           for gens in range(1, max_gens(r) + 1)]
    pad += [(PADDED, PADDED_WORDS, BOSCO, boundary, 1, PADDED)
            for boundary in ("periodic", "dead")]
    extra["padded"] = _padded_exact(rng, cuda_ltl_step, ltl_step_plain, pad)
    batch = [(B, rows, nw, rule, boundary, gens, col_limit)
             for B in BATCH
             for rows, nw in ((70, 31), (129, 33), (5, 1))
             for boundary in ("periodic", "dead")
             for rule, gens in ((R2, 1), (R2, 4), (BOSCO, 1))
             for col_limit in (None, WORD * nw - 24)]
    extra["batched"] = _batched_exact(rng, "K3", cuda_ltl_step,
                                      ltl_step_plain, batch)
    return n, err, extra


def _stripe_plans() -> list:
    """(kernel, rule, plan) of the sparse stripes: the plans of the sparse
    paths and CLI cases of phase 3 (Life at FLAGSHIP² and 512² on K1,
    Bosco at 480 x 500 on K2) and narrow ones (Highlife's one owned word
    and two halo words a tile; Bosco at T 128 with a two-word halo and at
    T 32 with one; R2; K2 at T 16 and 8)."""
    def plan(kid, rule, rows, cols, T, periodic=True):
        packed = kid != "K2"
        return (kid, rule, activity.make_plan(
            rows=rows, cols_units=cols // WORD if packed else cols,
            tile_px=T, radius=rule.radius, periodic=periodic, packed=packed))
    return [plan("K1", LIFE, FLAGSHIP, FLAGSHIP, SPARSE_T),
            plan("K1", LIFE, 512, 512, 32),
            plan("K1", HIGHLIFE, 64, 128, 32),
            plan("K3", BOSCO, 1024, 1024, 128),
            plan("K3", BOSCO, 256, 256, 32, periodic=False),
            plan("K3", R2, 256, 256, 32),
            plan("K2", BOSCO, 480, 500, 20, periodic=False),
            plan("K2", BOSCO, 48, 48, 16),
            plan("K2", LIFE, 128, 128, 8)]


def _stripe_exact(rng) -> dict:
    """Each kernel at a dead boundary and gens 1 on the stripes of
    ``_stripe_plans``, at every rung and at 1-3, 5 and 7 tiles (stripes of
    K1 and K3 whose rows do and do not move in 16-byte pieces), against its
    plain version."""
    wrappers = {"K1": (cuda_bit_step, bit_step_plain),
                "K2": (cuda_dense_step, dense_step_plain),
                "K3": (cuda_ltl_step, ltl_step_plain)}
    out = {kid: {"cases": 0, "max_abs_err": 0, "shapes": []}
           for kid in wrappers}
    for kid, rule, plan in _stripe_plans():
        kernel, plain = wrappers[kid]
        for K in sorted(set(plan.capacities) | {1, 2, 3, 5, 7}):
            shape = plan.stripe_shape(K)
            x = _cells(rng, shape) if kid == "K2" else _words(rng, shape)
            o = out[kid]
            o["max_abs_err"] = max(o["max_abs_err"], _compare(
                kernel, plain, x, rule, "dead", 1))
            o["cases"] += 1
            o["shapes"].append(list(shape))
    return out


def _mesh_window_exact(rng) -> dict:
    """K1-K3 at the shard windows phase 12's mesh paths launch them on (a
    shard with its ghosts, an edge shard, the Life overlap body's bands,
    the padded path's last shard with its local ``col_limit``, the dense
    path's aligned windows at each chunk depth) and at small ragged
    windows, dead boundary, against their plain versions, exact."""
    H, Hd, P = FLAGSHIP // 2, DENSE // 2, PADDED
    cases = {
        # (shape in rows and words or cells, rule, gens, col_limit)
        "K1": [((H + 16, 1026), LIFE, 8, None),     # Life 2x2, K 8
               ((H + 8, 1025), LIFE, 8, None),      # its dead corner shard
               ((32, 1026), LIFE, 8, None),         # overlap top band
               ((H + 16, 3), LIFE, 8, None),        # overlap lateral band
               ((P + 16, 1017), LIFE, 8, 32520),    # padded 1x2, shard 1
               ((P + 16, 1017), LIFE, 4, 32520),
               ((37, 5), HIGHLIFE, 3, 131), ((9, 2), LIFE, 16, 33)],
        "K3": [((FLAGSHIP + 10, 1026), BOSCO, 1, None),  # Bosco 1x2
               ((20, 1026), BOSCO, 1, None),        # overlap top band
               ((FLAGSHIP + 10, 4), BOSCO, 1, None),  # lateral band
               ((70, 9), R2, 4, 260), ((41, 3), BOSCO, 1, 80)],
        # dense Bosco 2x2 at comm_every 7: a pass's window is 35 ghosts a
        # side, its width padded to a multiple of 16 (K2's aligned rows),
        # stepped in chunks of 3, 3, 1; the last pass of 4 in 3, 1
        "K2": [((Hd + 70, Hd + 80), BOSCO, 3, None),
               ((Hd + 70, Hd + 80), BOSCO, 1, None),
               ((Hd + 40, Hd + 48), BOSCO, 3, None),
               ((Hd + 40, Hd + 48), BOSCO, 1, None),
               # a dead 2x2 mesh's corner shards: (0, 0) with its right
               # ghost (aligned), (1, 1) ending at the global edge (not)
               ((Hd + 35, Hd + 48), BOSCO, 3, None),
               ((Hd + 35, Hd + 35), BOSCO, 3, None),
               ((33, 70), R2, 8, None)],
    }
    # phase 14's batched shard windows: a coalesced round or a ticket
    # cohort of B boards on a mesh is one launch a shard, (B, h, w)
    for kid, rows in _mesh_batch_windows().items():
        cases[kid] += [(shape, rule, gens, limit)
                       for _label, shape, rule, gens, limit in rows]
    pairs = {"K1": (cuda_bit_step, bit_step_plain),
             "K3": (cuda_ltl_step, ltl_step_plain),
             "K2": (cuda_dense_step, dense_step_plain)}
    out = {}
    for kid, rows in cases.items():
        kernel, plain = pairs[kid]
        o = out[kid] = {"cases": 0, "max_abs_err": 0, "shapes": []}
        for shape, rule, gens, limit in rows:
            x = _cells(rng, shape) if kid == "K2" else _words(rng, shape)
            kw = {} if kid == "K2" else {"col_limit": limit}
            if limit is not None:  # a padded grid's pad is dead
                x = x & pad_mask(shape[-1], limit, "cuda")
            o["max_abs_err"] = max(o["max_abs_err"], _compare(
                kernel, plain, x, rule, "dead", gens, **kw))
            o["cases"] += 1
            o["shapes"].append([list(shape), gens, limit])
            del x
        torch.cuda.empty_cache()
    return out


def _mesh_batch_windows() -> dict:
    """The (B, h, w) shard windows phase 14's mesh sessions launch their
    kernel on, by kernel: (label, shape, rule, gens, local col_limit).
    Served Life: 32 boards of a 4096² 2x2 shard (2048 rows x 64 words)
    with 8 ghost rows and a ghost word a side, and a dead mesh's corner
    shard; Bosco tickets on 1x2 (the 1-wide row axis wraps onto itself, 5
    ghost rows); dense Bosco on 2x2 at comm_every 7 (35 ghosts a side, the
    width aligned to 16, chunks of 3 and 1); the padded periodic 4096 x
    4090 sessions on 1x2, shard 1's window cut to its 65 live words with
    the local col_limit (Life at comm_every 8, Bosco at 4)."""
    B, h, w = MESH_SERVE_LIFE[0], MESH_SERVE_LIFE[1] // 2, \
        MESH_SERVE_LIFE[1] // 2 // WORD
    d = MESH_TICKET_BOARDS
    s = MESH_LTL_SIZE
    dense = s // 2 + 70
    # the padded width's shard 1: its window starts at its left ghost word,
    # global word tw - 1, and keeps the words that hold a real cell
    prow, pcol = MESH_PADDED_SHAPE
    tw = -(-pcol // 2 // WORD)
    real = pcol - (tw - 1) * WORD
    live = -(-real // WORD)
    return {
        "K1": [("served_life_2x2", (B, h + 16, w + 2), LIFE, 8, None),
               ("served_life_2x2_dead_corner", (B, h + 8, w + 1), LIFE, 8,
                None),
               ("padded_life_1x2", (d, prow + 16, live), LIFE, 8, real)],
        "K3": [("bosco_1x2", (d, s + 10, s // 2 // WORD + 2), BOSCO, 1,
                None),
               ("padded_bosco_1x2_k4", (d, prow + 40, live), BOSCO, 1,
                real)],
        "K2": [("dense_bosco_2x2", (d, dense, dense + (-dense % 16)), BOSCO,
                3, None),
               ("dense_bosco_2x2_chunk_1", (d, dense, dense + (-dense % 16)),
                BOSCO, 1, None)],
    }


def phase2_exact() -> dict:
    rng = np.random.default_rng(SEED)
    errs = {}
    t0 = time.perf_counter()
    stripes = _stripe_exact(rng)
    emit({"phase": "stripe_vs_plain", "boundary": "dead", "gens": 1,
          "seconds": time.perf_counter() - t0, **stripes})
    for kid, check in (("K1", _k1_exact), ("K2", _k2_exact),
                       ("K3", _k3_exact)):
        t0 = time.perf_counter()
        cases, err, extra = check(rng)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        emit({"phase": "kernel_vs_plain", "kernel": kid, "cases": cases,
              "max_abs_err": err, "seconds": time.perf_counter() - t0,
              **extra})
        # the new modes' cases count in the kernel's error
        errs[kid] = max([err, stripes[kid]["max_abs_err"]]
                        + [v["max_abs_err"] for v in extra.values()
                           if isinstance(v, dict)])
    t0 = time.perf_counter()
    fused = _fused_exact(rng)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    emit({"phase": "kernel_vs_plain", "kernel": "seam",
          "seconds": time.perf_counter() - t0, **fused})
    errs["seam"] = max(v["max_abs_err"] for v in fused.values())
    t0 = time.perf_counter()
    windows = _mesh_window_exact(rng)
    emit({"phase": "mesh_windows_vs_plain", "boundary": "dead",
          "seconds": time.perf_counter() - t0, **windows})
    for kid, o in windows.items():
        errs[kid] = max(errs[kid], o["max_abs_err"])
    if any(errs.values()):
        fail(f"a kernel disagrees with its plain version (tolerance: exact): "
             f"{errs}")
    return errs


# -- phase 3: the main paths -------------------------------------------------

def _plain_final(kind, rows, cols, rule, steps, boundary="periodic",
                 comm_every=1):
    """The plain version's grid after ``steps`` generations from the same
    hash init, on the card: the kernel's plain version generation by
    generation, at the padded width with the pad zeroed after each one
    and, on a periodic padded grid, the seam band stepped by
    ``evolve_band`` and stitched after each pass of ``comm_every``."""
    if kind == "dense":
        g = init_dense(rows, cols, SEED, device="cuda")
        for _ in range(steps):
            g = dense_step_plain(g, rule, boundary)
        return g
    cols_eff = -(-cols // WORD) * WORD
    col_limit = cols if cols_eff != cols else None
    g = init_packed(rows, cols_eff, SEED, col_limit=col_limit, device="cuda")
    plain = bit_step_plain if kind == "bit" else ltl_step_plain

    def one_pass(src, k, dst):
        for _ in range(k):
            src = plain(src, rule, boundary, 1, col_limit=col_limit)
        return src

    def seam_pass(src, k, dst):
        d = k * rule.radius
        band = seam.evolve_band(seam.extract_band(src, cols, d), rule, k)
        return seam.stitch_band(one_pass(src, k, dst), band, cols, d)

    evolve = segmented_evolve(
        seam_pass if col_limit and boundary == "periodic" else one_pass,
        comm_every)
    return evolve(g, steps, None)[0]


# (label, kernel) -> phase 3's single-device final: the digest of its grid
# (packed words at the padded width, or cells), population, steady s, rate,
# and for the finals phase 13's groups hold their tiles to, each tile's
# region ``(pid, SHA-256 of its .golp body, population)`` on that mesh
FINALS = {}
# the mesh of each final whose tiles phase 13 checks region by region
GROUP_REGIONS = {("life", "K1"): (1, 2), ("bosco", "K3"): (1, 2),
                 ("bosco", "K2"): (2, 2), ("padded_life", "K1"): (1, 2)}
# np.packbits puts a byte's first cell in its top bit, a packed word's
# bytes (little-endian) hold it in their low bit
BITREV8 = [int(f"{b:08b}"[::-1], 2) for b in range(256)]
POPCOUNT8 = np.array([bin(b).count("1") for b in range(256)], dtype=np.int64)
GOLP_WEIGHTS = [128, 64, 32, 16, 8, 4, 2, 1]


def _golp_rows(g: torch.Tensor, kind: str, r0: int, r1: int, c0: int,
               c1: int, block: int = 4096):
    """The ``.golp`` body (``np.packbits`` rows) of the cells [r0:r1,
    c0:c1] of the device grid ``g`` (packed words or cells), a block of
    rows at a time, as host bytes; ``c1 - c0`` a multiple of 8, or ``c1``
    the real width (the pad past it is dead)."""
    rev = torch.tensor(BITREV8, dtype=torch.uint8, device=g.device)
    weights = torch.tensor(GOLP_WEIGHTS, dtype=torch.int32, device=g.device)
    nbytes = -(-(c1 - c0) // 8)
    for b0 in range(r0, r1, block):
        b1 = min(b0 + block, r1)
        if kind == "dense":
            cells = torch.nn.functional.pad(g[b0:b1, c0:c1],
                                            (0, -(c1 - c0) % 8))
            body = (cells.view(b1 - b0, nbytes, 8).to(torch.int32)
                    * weights).sum(-1).to(torch.uint8)
        else:
            if c0 % WORD:
                fail(f"a tile at column {c0} does not start a word")
            words = g[b0:b1, c0 // WORD:-(-c1 // WORD)].contiguous()
            body = rev[words.view(torch.uint8).long()][:, :nbytes]
        yield body.cpu().numpy().tobytes()


def _region_digests(g: torch.Tensor, kind: str, rows: int, cols: int,
                    comm_every: int, rule, boundary: str, shape) -> list:
    """``(pid, SHA-256, population)`` of each tile a run on the mesh
    ``shape`` writes, read off the device grid ``g``: the shards' regions
    at the mesh's padded width, cropped to the real width, a shard wholly
    in the pad writing none (``MeshEngine.tiles``)."""
    mi, mj = shape
    cfg = GolConfig(rows=rows, cols=cols, steps=1, rule=rule,
                    comm_every=comm_every, boundary=boundary)
    th, tw = rows // mi, backend.plan_mesh_engine(cfg, mi, mj)[1] // mj
    out = []
    for i in range(mi):
        for j in range(mj):
            c0 = j * tw
            if c0 >= cols:
                continue
            c1 = min(c0 + tw, cols)
            if (c1 - c0) % 8 and c1 != cols:
                fail(f"a tile of {c1 - c0} columns is not whole bytes")
            h, pop = hashlib.sha256(), 0
            for chunk in _golp_rows(g, kind, i * th, (i + 1) * th, c0, c1):
                h.update(chunk)
                pop += int(POPCOUNT8[np.frombuffer(chunk, np.uint8)].sum())
            out.append((i * mj + j, h.hexdigest(), pop))
    return out


def _digest(g: torch.Tensor) -> str:
    """SHA-256 of a device grid's bytes, read back a block of rows at a
    time."""
    h = hashlib.sha256()
    for r0 in range(0, g.shape[0], 4096):
        h.update(g[r0:r0 + 4096].contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def _blocks_differ(final: np.ndarray, g: torch.Tensor, packed: bool) -> int:
    """Blocks of 2048 rows where the host grid ``final`` differs from the
    device grid ``g`` (packed again on the card, at ``g``'s padded width,
    when ``g`` is packed)."""
    block, differ = 2048, 0
    pad = g.shape[-1] * WORD - final.shape[-1] if packed else 0
    for r0 in range(0, final.shape[0], block):
        cells = torch.from_numpy(final[r0:r0 + block]).cuda()
        if packed:
            cells = pack(torch.nn.functional.pad(cells, (0, pad)))
        differ += not torch.equal(cells, g[..., r0:r0 + block, :])
    return differ


def _drive(label, kid, kind, shape, rule, comm_every, steps,
           boundary="periodic") -> tuple:
    """``run_cuda`` on one main path with the kernels' launch counters reset
    just before; its whole final grid must equal the plain version's.
    Returns the path kernel's launches and the final grid."""
    rows, cols = shape
    cfg = GolConfig(rows=rows, cols=cols, steps=steps, seed=SEED, rule=rule,
                    comm_every=comm_every, boundary=boundary)
    plan = backend.plan_engine(cfg)
    if plan[0] != kind:
        fail(f"the {label} path routes to {plan[0]}, not {kind}")
    timer = PhaseTimer()
    for k in KERNELS.values():
        k.launches = 0
    final = backend.run_cuda(cfg, timer=timer)
    launches = {k: w.launches for k, w in KERNELS.items()}
    if launches[kid] == 0:
        fail(f"the {label} main path launched {kid} no time: {launches}")
    if final.shape != (rows, cols) or final.dtype != np.uint8:
        fail(f"run_cuda returned {final.shape} {final.dtype}")
    pop = int(final.sum(dtype=np.int64))
    g = _plain_final(kind, rows, cols, rule, steps, boundary, comm_every)
    plain_pop = (int(g.sum(dtype=torch.int64).item()) if kind == "dense"
                 else population(g))
    differ = _blocks_differ(final, g, kind != "dense")
    # phase 12 holds the mesh's grid of this config to this one, phase 13
    # its process groups' tiles
    FINALS[label, kid] = {"digest": _digest(g), "population": pop,
                          "steady_s": timer.nosetup_us / 1e6,
                          "cell_updates_per_s": timer.cells_per_sec(
                              rows, cols, steps)}
    if (label, kid) in GROUP_REGIONS:
        FINALS[label, kid]["regions"] = _region_digests(
            g, kind, rows, cols, comm_every, rule, boundary,
            GROUP_REGIONS[label, kid])
    del g
    torch.cuda.empty_cache()
    if pop != plain_pop or differ:
        fail(f"{label} main path population {pop} vs plain {plain_pop}; "
             f"{differ} blocks of 2048 rows differ from the plain grid")
    emit({"phase": "main_path", "path": label, "kernel": kid,
          "grid": [rows, cols], "cols_eff": plan[1], "pad_bits": plan[2],
          "seam": plan[2] > 0 and boundary == "periodic",
          "boundary": boundary, "rule": str(rule), "steps": steps,
          "comm_every": comm_every, "launches": launches,
          "grid_equal_to_plain": True, "population": pop,
          "plain_population": plain_pop,
          "setup_s": timer.setup_us / 1e6, "steady_s": timer.nosetup_us / 1e6,
          "cell_updates_per_s": timer.cells_per_sec(rows, cols, steps)})
    return launches[kid], final


def _drive_strip() -> None:
    """``run_cuda`` on ``SEAM_STRIP``: the padded periodic Life path's
    route (K1 with ``col_limit``, the seam band's one launch) at its full width
    and fewer rows, against ``dense_step_plain`` generation by generation
    on the real width, a plain version that uses none of the pad or seam
    code that ``_plain_final`` shares with the engine."""
    rows, steps = SEAM_STRIP
    label, _, kind, rule, k, _, boundary = PADDED_PATHS[0]
    cfg = GolConfig(rows=rows, cols=PADDED, steps=steps, seed=SEED,
                    rule=rule, comm_every=k, boundary=boundary)
    plan = backend.plan_engine(cfg)
    if plan[0] != kind or not plan[2]:
        fail(f"the {label} strip routes to {plan}, not padded {kind}")
    for w in [*KERNELS.values(), seam.fused_band]:
        w.launches = 0
    final = backend.run_cuda(cfg)
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    launches["seam"] = seam.fused_band.launches
    if not (launches["K1"] and launches["seam"]) or launches["K2"]:
        fail(f"the {label} strip launched {launches}: K1 and the seam "
             f"band's kernel expected, no K2")
    g = init_dense(rows, PADDED, SEED, device="cuda")
    for _ in range(steps):
        g = dense_step_plain(g, rule, boundary)
    equal = torch.equal(torch.from_numpy(final).cuda(), g)
    del g
    torch.cuda.empty_cache()
    if not equal:
        fail(f"the {label} strip ({rows} x {PADDED}, {steps} gens) differs "
             f"from dense_step_plain's")
    emit({"phase": "seam_strip", "path": label, "grid": [rows, PADDED],
          "cols_eff": plan[1], "pad_bits": plan[2], "rule": str(rule),
          "steps": steps, "comm_every": k, "launches": launches,
          "equal_to_dense_step_plain": True})


def _drive_batched() -> int:
    """The batched path: ``BATCH_PATH``'s boards stepped by
    ``step_batched`` (passes of comm_every), then a ``step_batched_units``
    stretch at depth 1, K1's launch counter reset just before; one launch
    per pass for the whole batch, and every board equal to the plain
    version's."""
    label, B, size, rule, k, steps, units = BATCH_PATH
    cfg = GolConfig(rows=size, cols=size, steps=0, seed=SEED, rule=rule,
                    comm_every=k)
    engine = backend.build_engine(cfg)
    seeds = [SEED + b for b in range(B)]
    grids = engine.init_grids(seeds=seeds)
    engine.warm_up(boards=B)
    engine.sync()
    for w in KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    grids = engine.step_batched(grids, steps)
    engine.sync()
    t1 = time.perf_counter()
    grids = engine.step_batched_units(grids, units)
    engine.sync()
    t2 = time.perf_counter()
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    passes = -(-steps // k) + units
    if launches != {"K1": passes, "K2": 0, "K3": 0}:
        fail(f"the batched path launched {launches}, expected {passes} K1 "
             f"launches (one a pass for {B} boards)")
    pops = engine.population_batched(grids)
    want = torch.stack([init_packed(size, size, s, device="cuda")
                        for s in seeds])
    for _ in range(steps + units):
        want = bit_step_plain(want, rule, "periodic", 1)
    want_pops = [population(w) for w in want]
    if not torch.equal(grids, want) or pops != want_pops:
        fail(f"the batched path's boards differ from the plain version's "
             f"(populations {pops[:4]}... vs {want_pops[:4]}...)")
    del want, grids
    torch.cuda.empty_cache()
    cells = B * size * size
    emit({"phase": "main_path", "path": label, "kernel": "K1",
          "boards": B, "grid": [size, size], "rule": str(rule),
          "steps": steps, "comm_every": k, "units_after": units,
          "launches": launches, "grid_equal_to_plain": True,
          "populations_first_4": pops[:4],
          "step_batched_s": t1 - t0,
          "cell_updates_per_s": cells * steps / (t1 - t0),
          "step_batched_units_s": t2 - t1,
          "units_cell_updates_per_s": cells * units / (t2 - t1)})
    return launches["K1"]


def _sparse_board() -> torch.Tensor:
    """The sparse Life path's board at FLAGSHIP², packed on the card: the
    reference's ``quiescent_board(SPARSE_ACTIVE)`` on SPARSE_T² tiles (a
    horizontal blinker at the middle of each of the first k tiles of a
    square block, row by row) and an 8 x 8 lattice of gliders, each 300
    cells short of a lattice corner, so that they cross tile edges and the
    last row and column of them the periodic seam (SPARSE_GLIDERS)."""
    N, T = FLAGSHIP, SPARSE_T
    k = int(round(SPARSE_ACTIVE * (N // T) ** 2))
    side = int(np.ceil(np.sqrt(max(k, 1))))
    grid = torch.zeros((N, N // WORD), dtype=torch.int32, device="cuda")
    p = torch.arange(k, device="cuda")
    rows, first = (p // side) * T + T // 2, (p % side) * T + T // 2 - 1
    for dc in range(3):  # cells first .. first + 2 of each row
        c = first + dc
        grid.view(-1).index_put_(
            (rows * (N // WORD) + c // WORD,),
            torch.ones_like(c, dtype=torch.int32) << (c % WORD).int(),
            accumulate=True)
    lattice = N // 8
    for a in range(8):
        for b in range(8):
            r0, c0 = (a + 1) * lattice - 300, (b + 1) * lattice - 300
            if a == b == 7:  # else it wraps both seams into the blinkers
                c0 -= lattice // 2
            for dr, row in enumerate(GLIDER):
                for dc, cell in enumerate(row):
                    if cell:
                        c = c0 + dc
                        grid[r0 + dr, c // WORD] |= 1 << (c % WORD)
    return grid


def _soup_board() -> torch.Tensor:
    """The reference's soup at FLAGSHIP²: each cell live with probability
    SOUP[0], drawn on the card from SEED and packed 4096 rows at a time."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grid = torch.empty((FLAGSHIP, FLAGSHIP // WORD), dtype=torch.int32,
                       device="cuda")
    for r0 in range(0, FLAGSHIP, 4096):
        cells = torch.rand((4096, FLAGSHIP), generator=gen, device="cuda")
        grid[r0:r0 + 4096] = pack((cells < SOUP[0]).to(torch.uint8))
    return grid


def _sparse_engine():
    cfg = GolConfig(rows=FLAGSHIP, cols=FLAGSHIP, steps=0, seed=SEED,
                    sparse_tile=SPARSE_T)
    engine = backend.build_engine(cfg)
    if engine.kind != "bit" or engine.sparse_plan is None:
        fail(f"the sparse Life path planned {engine.kind}, "
             f"{engine.sparse_plan}")
    return engine


def _dense_engine(comm_every: int):
    return backend.build_engine(GolConfig(rows=FLAGSHIP, cols=FLAGSHIP,
                                          steps=0, seed=SEED,
                                          comm_every=comm_every))


def _drive_sparse(label: str, board: torch.Tensor, steps: int,
                  plain: bool) -> int:
    """The sparse Life engine from ``board``: one generation (the probe that
    settles the all-ones start), then ``steps - 1`` in one dispatch, K1's
    counter reset just before.  The whole final grid must equal the dense
    K1 engine's (comm_every 8) and, when ``plain``, the plain version's,
    generation by generation."""
    engine = _sparse_engine()
    state = activity.initial_state(board.clone(), engine.sparse_plan)
    engine.warm_up()
    engine.sync()
    evolve = engine._evolve
    for w in KERNELS.values():
        w.launches = 0
    t0 = time.perf_counter()
    state = engine.step(state, 1)
    settled = engine.sparse_stats(state)
    phases0, reads0 = Counter(evolve.phases), evolve.reads
    t1 = time.perf_counter()
    state = engine.step(state, steps - 1)
    engine.sync()
    t2 = time.perf_counter()
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    if launches["K1"] == 0 or launches["K2"] or launches["K3"]:
        fail(f"the {label} path launched {launches}: K1 alone expected")
    stats = engine.sparse_stats(state)
    pop = engine.population(state)
    dense = _dense_engine(MAIN_GENS)
    dense.warm_up()
    g = dense.step(board.clone(), steps)
    equal_dense = torch.equal(g, state.grid)
    del g, dense
    equal_plain = None
    if plain:
        g = board
        for _ in range(steps):
            g = bit_step_plain(g, LIFE, "periodic", 1)
        equal_plain = torch.equal(g, state.grid)
        del g
    del state
    torch.cuda.empty_cache()
    if not equal_dense or equal_plain is False:
        fail(f"the {label} path's final grid differs from the dense K1 "
             f"engine's ({equal_dense}) or the plain version's "
             f"({equal_plain})")
    emit({"phase": "main_path", "path": label, "kernel": "K1",
          "grid": [FLAGSHIP, FLAGSHIP], "sparse_tile": SPARSE_T,
          "plan": engine.sparse_plan.__dict__, "steps": steps,
          "launches": launches, "equal_to_dense_k1": equal_dense,
          "equal_to_plain": equal_plain, "population": pop,
          "stats_after_settle": settled, "stats_final": stats,
          "phases": {" ".join(map(str, k)): v for k, v in
                     (evolve.phases - phases0).items()},
          "host_reads": evolve.reads - reads0,
          "settle_s": t1 - t0, "steady_s": t2 - t1,
          "ms_per_generation": (t2 - t1) * 1e3 / (steps - 1),
          "cell_updates_per_s": FLAGSHIP ** 2 * (steps - 1) / (t2 - t1)})
    return launches["K1"]


def _drive_deep(final_k3: np.ndarray) -> int:
    """``run_cuda`` on DEEP_PATH: comm_every 4 at r 5 runs K2 passes of 3,
    so its final grid must equal DENSE_PATH's (comm_every 3)."""
    label, rule, k, steps = DEEP_PATH
    cfg = GolConfig(rows=DENSE, cols=DENSE, steps=steps, seed=SEED,
                    rule=rule, comm_every=k)
    if (backend.select_engine(cfg), backend.pass_depth(cfg)) != ("dense", 3):
        fail(f"the {label} path plans {backend.select_engine(cfg)} at "
             f"depth {backend.pass_depth(cfg)}")
    for w in KERNELS.values():
        w.launches = 0
    timer = PhaseTimer()
    final = backend.run_cuda(cfg, timer=timer)
    launches = {kid: w.launches for kid, w in KERNELS.items()}
    # a pass of 3 (and a remainder of 1) for 1201 generations, and the
    # warm-up's one launch at each depth
    want = -(-steps // 3) + 2
    if launches != {"K1": 0, "K2": want, "K3": 0}:
        fail(f"the {label} path launched {launches}, expected {want} K2")
    if not np.array_equal(final, final_k3):
        fail(f"the {label} path's final grid differs from the comm_every-3 "
             f"path's")
    emit({"phase": "main_path", "path": label, "kernel": "K2",
          "grid": [DENSE, DENSE], "rule": str(rule), "steps": steps,
          "comm_every": k, "pass_depth": 3, "launches": launches,
          "equal_to_comm_every_3": True,
          "population": int(final.sum(dtype=np.int64)),
          "setup_s": timer.setup_us / 1e6, "steady_s": timer.nosetup_us / 1e6,
          "cell_updates_per_s": timer.cells_per_sec(DENSE, DENSE, steps)})
    return launches["K2"]


def _cli_cases(d: str) -> None:
    """The CLI against the serial oracle: every ``.gol`` file byte for
    byte, and the kernel the run should take launched."""
    # 500 is not a whole number of words: Life at comm_every 3 and Bosco
    # at 1 take K1 and K3 padded (dead) and with the seam band (periodic);
    # Bosco at 2 stays on K2, at 4 (20 cells of halo) in K2 passes of 3;
    # sparse runs on K1 (Life) and, at a width that is not whole words, K2
    cases = [(512, 512, "life", ["--comm-every", "4"], "K1"),
             (512, 512, "bosco", ["--comm-every", "1"], "K3"),
             (500, 500, "life", ["--comm-every", "3"], "K1"),
             (500, 500, "bosco", ["--comm-every", "1"], "K3"),
             (500, 500, "bosco", ["--comm-every", "2"], "K2"),
             (512, 512, "bosco", ["--comm-every", "4"], "K2"),
             (512, 512, "life", ["--sparse", "32"], "K1"),
             (480, 500, "bosco", ["--sparse", "20"], "K2")]
    for rows, cols, rule, extra, kid in cases:
        for boundary in ("periodic", "dead"):
            common = [str(rows), str(cols), "10", "30", "--save", "--seed",
                      "5", "--rule", rule, "--boundary", boundary, "--quiet",
                      "--name", "n"]
            tag = f"{rows}x{cols}-{rule}-{'-'.join(extra)}-{boundary}"
            cu, ser = os.path.join(d, f"cu-{tag}"), os.path.join(d, f"se-{tag}")
            KERNELS[kid].launches = 0
            rc = (cli_main(common + ["--out-dir", cu] + extra),
                  cli_main(common + ["--out-dir", ser, "--backend", "serial"]))
            if rc != (0, 0):
                fail(f"CLI exit codes {rc} ({tag})")
            if KERNELS[kid].launches == 0:
                fail(f"the CLI run {tag} launched {kid} no time")
            names = sorted(f for f in os.listdir(ser) if f.endswith(".gol"))
            _, mismatch, errors = filecmp.cmpfiles(ser, cu, names, shallow=False)
            if len(names) != 5 or mismatch or errors:
                fail(f"CLI .gol files differ from the serial oracle ({tag}): "
                     f"{mismatch + errors}")
    emit({"phase": "cli", "cases": [f"{h}x{w} {r} {' '.join(e)} ({k})"
                                    for h, w, r, e, k in cases],
          "boundaries": ["periodic", "dead"],
          "gol_files_identical_to_serial": True})


def phase3_main_paths() -> dict:
    square = (FLAGSHIP, FLAGSHIP)
    launches = {"K1": _drive("life", "K1", "bit", square, LIFE, MAIN_GENS,
                             MAIN_STEPS)[0]}
    launches["K3"] = {label: _drive(label, "K3", "ltl", square, rule, k, n)[0]
                      for label, rule, k, n in LTL_PATHS}
    label, rule, k, n = DENSE_PATH
    launches["K2"], final_k3 = _drive(label, "K2", "dense", (DENSE, DENSE),
                                      rule, k, n)
    launches[DEEP_PATH[0]] = _drive_deep(final_k3)
    del final_k3
    for label, kid, kind, rule, k, n, boundary in PADDED_PATHS:
        launches[label] = _drive(label, kid, kind, (PADDED, PADDED), rule, k,
                                 n, boundary)[0]
    _drive_strip()
    launches[BATCH_PATH[0]] = _drive_batched()
    launches["sparse_life"] = _drive_sparse("sparse_life", _sparse_board(),
                                            SPARSE_STEPS, plain=True)
    launches["sparse_soup"] = _drive_sparse("sparse_soup", _soup_board(),
                                            SOUP[1], plain=False)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        _cli_cases(d)
    return launches


# -- phase 4: times ----------------------------------------------------------

def _events_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _ping_pong(fn, x):
    """A callable that runs ``fn(src, dst)`` once, alternating two buffers
    as the engine does, starting from a copy of ``x``."""
    bufs = [x.clone(), torch.empty_like(x)]

    def one():
        fn(bufs[0], bufs[1])
        bufs.reverse()
    return one


def _pass_ms(kernel, x, rule, gens, reps=20, boundary="periodic") -> float:
    """ms per pass, ping-ponging as the engine does: each pass reads the
    last output."""
    one_pass = _ping_pong(
        lambda a, b: kernel(a, rule, boundary, gens, out=b), x)
    for _ in range(3):
        one_pass()
    return _events_ms(one_pass, reps)


def _plain_ms(plain, x, rule, gens, boundary="periodic", **kw) -> float:
    plain(x, rule, boundary, gens, **kw)  # warm the allocator
    return _events_ms(lambda: plain(x, rule, boundary, gens, **kw), 2)


def _row(card, kid, grid, rule, gens, ms, plain_ms, t_bytes, t_ops, **extra):
    cells = grid[0] * grid[1]
    row = {"phase": "times", "card": card, "kernel": kid, "grid": grid,
           "rule": str(rule), "gens": gens, "ms": ms,
           "cell_updates_per_s": cells * gens / (ms / 1e3),
           "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "bytes_ms": t_bytes, "operations_ms": t_ops, **extra}
    emit(row)
    return row


# K1's variants by the macros that select them in csrc/bitlife.cu; "kept"
# is the design every wrapper and main path runs ("no_col_limit" is it
# without the code for padded grids, which an unpadded pass must not pay
# for).  "as_before" puts
# together what the kernel did before its redesign: the rule from run-time
# masks, one word a lane, the end lanes zeroing their shuffled sums, every
# CTA masking every word.
K1_VARIANTS = {
    "kept": None,
    "rule_gates": {"K1_RULE_GATES": 1},
    "rule_masks": {"K1_RULE_MASKS": 1},
    "as_before": {"K1_RULE_MASKS": 1, "K1_WPL": 1, "K1_ZERO_GHOSTS": 1,
                  "K1_EDGE_TESTS": 1},
    "words_per_lane_1": {"K1_WPL": 1},
    "words_per_lane_2": {"K1_WPL": 2},
    "ghost_lanes": {"K1_GHOST": 4},
    "ghost_lanes_through_registers": {"K1_GHOST": 4, "K1_CP_ASYNC": 0},
    "load_through_registers": {"K1_CP_ASYNC": 0},
    "zero_ghosts": {"K1_ZERO_GHOSTS": 1},
    "edge_tests": {"K1_EDGE_TESTS": 1},
    "ghost_lanes_rows_128": {"K1_GHOST": 4, "K1_ROWS": 128},
    "rows_64": {"K1_ROWS": 64},
    "rows_128": {"K1_ROWS": 128},
    "rows_192": {"K1_ROWS": 192},
    "no_col_limit": {"K1_COL_LIMIT": 0},
}


def _k1_turns(card: str, x: torch.Tensor) -> None:
    """K1's kept design and its variants on the 65536² grid at gens 8, 4,
    2 and 1, in turns: every variant once in order and once in reverse, so
    each is timed early and late (for two, that is old, new, new, old).
    Each variant's output must equal the kept design's."""
    names = list(K1_VARIANTS)
    t0 = time.perf_counter()
    paths = _build.build_rules("bit", [LIFE] * len(names),
                               list(K1_VARIANTS.values()))
    build_s = time.perf_counter() - t0
    libs = {n: _build.load_rule_library("bit", LIFE, K1_VARIANTS[n])
            for n in names}
    for n in names:
        if (K1_VARIANTS[n] or {}).get("K1_RULE_MASKS"):
            err = libs[n].gol_bit_set_masks(LIFE.birth_mask,
                                            LIFE.survive_mask)
            if err:
                fail(f"gol_bit_set_masks failed for {n}: CUDA error {err}")
    emit({"phase": "k1_variants", "card": card, "rule": rule_key(LIFE),
          "defines": K1_VARIANTS, "build_seconds_all_variants": build_s,
          "ptxas": {n: _build.kernel_resources(p)
                    for n, p in zip(names, paths)},
          "ctas_per_sm": {n: {g: libs[n].gol_bit_ctas_per_sm(g)
                              for g in (1, 4, 8)} for n in names}})
    out, want = torch.empty_like(x), torch.empty_like(x)
    for gens in sorted({2, *MAIN_DEPTHS}, reverse=True):
        bit_launch(libs["kept"], x, want, "periodic", gens)
        ms = {n: [] for n in names}
        for n in names + names[::-1]:
            def one_pass(lib=libs[n]):
                bit_launch(lib, x, out, "periodic", gens)
            for _ in range(3):
                one_pass()
            ms[n].append(_events_ms(one_pass, 10))
            if not torch.equal(out, want):
                fail(f"K1 variant {n} differs from the kept design at gens "
                     f"{gens}")
        emit({"phase": "k1_turns", "card": card, "rule": rule_key(LIFE),
              "gens": gens, "grid": [FLAGSHIP, FLAGSHIP], "ms": ms,
              "fastest": min(names, key=lambda n: sum(ms[n]))})


def _k3_run_turns(card: str, x: torch.Tensor) -> None:
    """K3's run lengths (``-DK3_ROWS``, the rows a warp steps at most:
    ``cuda_bitltl.BLOCK_ROWS`` from 64) at every radius's gens 1 and
    deepest pass and at the main paths' depths, in turns (each in order,
    then in reverse), ms per pass on the 65536² grid, beside the default
    (``cuda_bitltl.DEFAULT_ROWS``)."""
    rows = [r for r in sorted(BLOCK_ROWS_K3) if r >= 64]
    configs = [(rule, g) for r, rule in LTL_RULES.items()
               for g in sorted({1, max_gens(r)})]
    configs += [(rule, g) for _, rule, k, n in LTL_PATHS
                for g in sorted({k, n % k} - {0})
                if (rule, g) not in configs]
    t0 = time.perf_counter()
    for n in rows:
        _build.build_rules("ltl", [rule for rule, _ in configs],
                           {"K3_ROWS": n})
    build_s = time.perf_counter() - t0
    out = torch.empty_like(x)
    for rule, gens in configs:
        fns = {n: (lambda lib=_build.load_rule_library(
                   "ltl", rule, {"K3_ROWS": n}): ltl_launch(
                   lib, x, out, rule, "periodic", gens))
               for n in rows}
        ms = _turns(fns)
        emit({"phase": "k3_runs", "card": card, "rule": rule_key(rule),
              "gens": gens, "grid": [FLAGSHIP, FLAGSHIP], "ms": ms,
              "fastest": min(rows, key=lambda n: sum(ms[n])),
              "default": K3_DEFAULT_ROWS,
              "build_seconds_all_runs_all_rules": build_s})


def _turns(fns: dict, reps: int = 10) -> dict:
    """ms per call of each of ``fns`` (name -> callable), in turns: every
    one in order, then in reverse, each warmed up three times first."""
    ms = {n: [] for n in fns}
    for n in list(fns) + list(fns)[::-1]:
        for _ in range(3):
            fns[n]()
        ms[n].append(_events_ms(fns[n], reps))
    return ms


def _seam_pass(rule, C, k, kernel=cuda_bit_step):
    """A callable (src, dst) running one pass of the padded periodic engine:
    ``kernel`` (K1 or K3) with ``col_limit``, then the seam band's one
    launch."""
    evolve = seam.make_seam_stepper(
        lambda src, g, dst: kernel(src, rule, "periodic", g, out=dst,
                                   col_limit=C),
        rule, C, k)
    return lambda src, dst: evolve(src, k, dst)


def _padded_times(card: str, rows: dict) -> None:
    """The padded paths at PADDED², in turns: Life's gens-8 pass as K1 with
    ``col_limit`` alone, as the engine runs it (with the seam band's one
    launch), and forced onto K2 (uint8 cells, periodic); the band alone in
    one launch and on ``evolve_band``; the dead Bosco pass on K3 with
    ``col_limit`` against K2."""
    C, k = PADDED, PADDED_PATHS[0][4]
    x = init_packed(PADDED, PADDED_WORDS * WORD, SEED, col_limit=C,
                    device="cuda")
    words = x.numel()
    dense = init_dense(PADDED, PADDED, SEED, device="cuda")
    d = k * LIFE.radius
    band = _cells(np.random.default_rng(SEED), (PADDED, 4 * d))
    stitched = cuda_bit_step(x, LIFE, "periodic", k, col_limit=C)
    lib, table = _build.load_library(), rule_table(LIFE)
    stream = torch.cuda.current_stream().cuda_stream
    life = _turns({
        "k1_col_limit": _ping_pong(
            lambda a, b: cuda_bit_step(a, LIFE, "periodic", k, out=b,
                                       col_limit=C), x),
        "engine_pass_fused": _ping_pong(_seam_pass(LIFE, C, k), x),
        # the kernel alone, its library called as the wrapper calls it
        "band_fused": lambda: lib.gol_seam_band(
            x.data_ptr(), stitched.data_ptr(), 1, PADDED, PADDED_WORDS, C,
            LIFE.radius, k, table, stream),
        "band_evolve_band": lambda: seam.evolve_band(band, LIFE, k),
        "k2_forced": _ping_pong(
            lambda a, b: cuda_dense_step(a, LIFE, "periodic", k, out=b),
            dense),
    })
    mean = {n: sum(v) / len(v) for n, v in life.items()}
    emit({"phase": "padded_times", "card": card, "path": "padded_life",
          "grid": [PADDED, PADDED], "cols_eff": PADDED_WORDS * WORD,
          "gens": k, "ms": life,
          "seam_share_of_engine_pass":
              1 - mean["k1_col_limit"] / mean["engine_pass_fused"],
          "k2_forced_over_engine_pass":
              mean["k2_forced"] / mean["engine_pass_fused"]})
    rows["K1", "padded"] = _row(
        card, "K1", [PADDED, PADDED], LIFE, k, mean["k1_col_limit"],
        _plain_ms(bit_step_plain, x, LIFE, k, col_limit=C),
        8 * words / HBM_BYTES_PER_S * 1e3,
        k * words * word_ops(LIFE) / INT32_OPS_PER_S * 1e3,
        mode="col_limit", col_limit=C, library_ms=None)
    cells = band.numel()
    # the band in one launch: the strip's words read, the seam's words read
    # and written, K2's operations on the strip's cells
    seam_words = len(seam.strip_words(C, d)) + 2 * len(
        {c // WORD for c in [*range(C - d, C), *range(d)]})
    rows["seam", "fused"] = _row(
        card, "seam", list(band.shape), LIFE, k, mean["band_fused"],
        mean["band_evolve_band"],
        4 * PADDED * seam_words / HBM_BYTES_PER_S * 1e3,
        k * cells * K2_CELL_OPS / INT32_OPS_PER_S * 1e3, mode="seam_band",
        ops_per_cell=K2_CELL_OPS, library_ms=None,
        plain_note="evolve_band, timed in the turns above")
    bosco = _turns({
        "k3_col_limit": _ping_pong(
            lambda a, b: cuda_ltl_step(a, BOSCO, "dead", 1, out=b,
                                       col_limit=C), x),
        "k2_forced": _ping_pong(
            lambda a, b: cuda_dense_step(a, BOSCO, "dead", 1, out=b), dense),
    })
    mean = {n: sum(v) / len(v) for n, v in bosco.items()}
    emit({"phase": "padded_times", "card": card, "path": "padded_bosco",
          "grid": [PADDED, PADDED], "boundary": "dead", "gens": 1,
          "ms": bosco,
          "k2_forced_over_k3": mean["k2_forced"] / mean["k3_col_limit"]})
    rows["K3", "padded"] = _row(
        card, "K3", [PADDED, PADDED], BOSCO, 1, mean["k3_col_limit"],
        _plain_ms(ltl_step_plain, x, BOSCO, 1, boundary="dead",
                  col_limit=C),
        8 * words / HBM_BYTES_PER_S * 1e3,
        words * ltl_word_ops_lower(BOSCO) / INT32_OPS_PER_S * 1e3,
        mode="col_limit", col_limit=C, boundary="dead", library_ms=None)
    del x, dense, band, stitched
    torch.cuda.empty_cache()


def _batched_times(card: str, rows: dict) -> None:
    """A pass over a batch in one launch against the same boards in one
    launch each (BATCH_PATH's 32 boards of 4096²), in turns: K1 at gens 8
    and 1, K3 (Bosco, gens 1), and K2 on 16 boards (Bosco, gens 3: the
    cells of its 16384² path)."""
    _, B, size, _, k, _, _ = BATCH_PATH
    x = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                     for b in range(B)])
    cells = torch.stack([init_dense(size, size, SEED + b, device="cuda")
                         for b in range(B // 2)])
    out = {}
    for kid, wrapper, grids, rule, gens in (
            ("K1", cuda_bit_step, x, LIFE, k),
            ("K1", cuda_bit_step, x, LIFE, 1),
            ("K3", cuda_ltl_step, x, BOSCO, 1),
            ("K2", cuda_dense_step, cells, BOSCO, DENSE_PATH[2])):
        o = torch.empty_like(grids)

        def batched(w=wrapper, g=grids, r=rule, n=gens):
            w(g, r, "periodic", n, out=o)

        def solo(w=wrapper, g=grids, r=rule, n=gens):
            for b in range(g.shape[0]):
                w(g[b], r, "periodic", n, out=o[b])

        before = wrapper.launches
        batched()
        if wrapper.launches != before + 1:
            fail(f"a batched {kid} pass took {wrapper.launches - before} "
                 f"launches")
        ms = _turns({"batched": batched, "solo": solo}, reps=10)
        mean = {n: sum(v) / len(v) for n, v in ms.items()}
        n_boards = grids.shape[0]
        emit({"phase": "batched_times", "card": card, "kernel": kid,
              "boards": n_boards, "grid": [size, size], "rule": str(rule),
              "gens": gens, "ms_per_pass": ms,
              "ms_per_board_generation": {
                  n: v / (n_boards * gens) for n, v in mean.items()},
              "solo_over_batched": mean["solo"] / mean["batched"]})
        out[kid, gens] = mean["batched"]
        n = grids.numel()
        if kid == "K2":
            t_bytes = 2 * n / HBM_BYTES_PER_S * 1e3
            t_ops = gens * n * K2_CELL_OPS / INT32_OPS_PER_S * 1e3
            plain = dense_step_plain
        else:
            t_bytes = 8 * n / HBM_BYTES_PER_S * 1e3
            ops = word_ops(LIFE) if kid == "K1" else ltl_word_ops_lower(rule)
            t_ops = gens * n * ops / INT32_OPS_PER_S * 1e3
            plain = bit_step_plain if kid == "K1" else ltl_step_plain
        if (kid, gens) != ("K1", 1):
            rows[kid, "batched"] = _row(
                card, kid, [n_boards, size, size], rule, gens,
                mean["batched"], _plain_ms(plain, grids, rule, gens),
                t_bytes, t_ops, mode="boards", library_ms=None)
    del x, cells
    torch.cuda.empty_cache()


def _sparse_times(card: str, rows: dict) -> None:
    """The sparse Life engine against the dense K1 engine at comm_every 1
    and 8 on the same boards (the sparse path's and the soup), SPARSE_TIMED
    generations a dispatch, in turns, in ms a generation (CUDA events
    around each dispatch: with the host's reads inside, the device's whole
    span, idle time included); and the stripe step (K1, dead, gens 1, at
    the top rung of the sparse path's plan and at its lower) against its
    bound."""
    n = SPARSE_TIMED
    for label, make in (("sparse_life", _sparse_board),
                        ("sparse_soup", _soup_board)):
        board = make()
        sparse = _sparse_engine()
        engines = {"sparse": sparse, "dense_1": _dense_engine(1),
                   "dense_8": _dense_engine(MAIN_GENS)}
        states = {"sparse": sparse.step(
            activity.initial_state(board.clone(), sparse.sparse_plan), 1)}
        for name in ("dense_1", "dense_8"):
            states[name] = board.clone()
        del board
        for e in engines.values():
            e.warm_up()

        def runner(name):
            def run():
                states[name] = engines[name].step(states[name], n)
            return run

        reads = sparse._evolve.reads
        ms = _turns({name: runner(name) for name in engines}, reps=1)
        per_gen = {name: sum(v) / len(v) / n for name, v in ms.items()}
        emit({"phase": "sparse_times", "card": card, "path": label,
              "grid": [FLAGSHIP, FLAGSHIP], "sparse_tile": SPARSE_T,
              "generations_a_dispatch": n, "ms_per_dispatch": ms,
              "ms_per_generation": per_gen,
              "dense_1_over_sparse": per_gen["dense_1"] / per_gen["sparse"],
              "dense_8_over_sparse": per_gen["dense_8"] / per_gen["sparse"],
              "stats": sparse.sparse_stats(states["sparse"]),
              "host_reads_per_dispatch":
                  (sparse._evolve.reads - reads) / len(ms["sparse"]) / 4})
        rows[label] = per_gen
        del states, engines, sparse
        torch.cuda.empty_cache()
    plan = _stripe_plans()[0][2]
    for K in plan.capacities:
        shape = plan.stripe_shape(K)
        x = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, 2**32, size=shape, dtype=np.uint32).view(np.int32)).cuda()
        one = _ping_pong(lambda a, b: cuda_bit_step(a, LIFE, "dead", 1, out=b),
                         x)
        for _ in range(3):
            one()
        words = x.numel()
        rows["K1", "stripe", K] = _row(
            card, "K1", [shape[0], shape[1] * WORD], LIFE, 1,
            _events_ms(one, 50),
            _plain_ms(bit_step_plain, x, LIFE, 1, boundary="dead"),
            8 * words / HBM_BYTES_PER_S * 1e3,
            words * word_ops(LIFE) / INT32_OPS_PER_S * 1e3,
            mode=f"sparse stripe, {K} tiles, dead", library_ms=None)
        del x


def phase4_times(card: str) -> dict:
    rows = {}
    x = init_packed(FLAGSHIP, FLAGSHIP, SEED, device="cuda")
    words = x.numel()
    for gens in MAIN_DEPTHS:  # K1: 8 B per word per pass; word_ops per gen
        rows["K1", gens] = _row(
            card, "K1", [FLAGSHIP, FLAGSHIP], LIFE, gens,
            _pass_ms(cuda_bit_step, x, LIFE, gens),
            _plain_ms(bit_step_plain, x, LIFE, gens),
            8 * words / HBM_BYTES_PER_S * 1e3,
            gens * words * word_ops(LIFE) / INT32_OPS_PER_S * 1e3,
            word_ops=word_ops(LIFE), library_ms=None,
            library_note="no single PyTorch call computes a Life generation")
    for label, rule, k, n in LTL_PATHS:  # K3: as K1, from below and above
        lower = ltl_word_ops_lower(rule)
        upper = ltl_word_ops(rule, "row_first")
        for gens in sorted({k, n % k} - {0}):
            t_bytes = 8 * words / HBM_BYTES_PER_S * 1e3
            rows["K3", label, gens] = _row(
                card, "K3", [FLAGSHIP, FLAGSHIP], rule, gens,
                _pass_ms(cuda_ltl_step, x, rule, gens, reps=10),
                _plain_ms(ltl_step_plain, x, rule, gens),
                t_bytes, gens * words * lower / INT32_OPS_PER_S * 1e3,
                word_ops_lower=lower, word_ops_upper=upper,
                bound_ms_upper_count=max(
                    t_bytes, gens * words * upper / INT32_OPS_PER_S * 1e3),
                library_ms=None,
                library_note="no single PyTorch call computes a "
                             "Larger-than-Life generation")
    _k1_turns(card, x)
    _k3_run_turns(card, x)
    del x
    torch.cuda.empty_cache()

    label, rule, k, n = DENSE_PATH
    x = init_dense(DENSE, DENSE, SEED, device="cuda")
    cells, r = x.numel(), rule.radius
    # the counts alone, as one library call: a (2r+1)² box of ones over the
    # pre-padded grid in float16 (exact: counts <= 225 < 2048)
    padded = pad_grid(x, r, "periodic")
    box = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), dtype=torch.half,
                     device="cuda")
    conv_in = padded.half()[None, None]
    conv = lambda: torch.nn.functional.conv2d(conv_in, box)  # noqa: E731
    # let cuDNN time its algorithms for this shape and keep the fastest
    torch.backends.cudnn.benchmark = True
    if not torch.equal((conv()[0, 0] - x.half()).to(torch.uint8),
                       counts_from_padded(padded, r)):
        fail("conv2d's counts differ from the plain counts")
    library_ms = _events_ms(conv, 10)
    torch.backends.cudnn.benchmark = False
    del padded, conv_in
    for gens in sorted({k, n % k} - {0}):  # K2: 2 B per cell per pass
        rows["K2", gens] = _row(
            card, "K2", [DENSE, DENSE], rule, gens,
            _pass_ms(cuda_dense_step, x, rule, gens, reps=10),
            _plain_ms(dense_step_plain, x, rule, gens),
            2 * cells / HBM_BYTES_PER_S * 1e3,
            gens * cells * K2_CELL_OPS / INT32_OPS_PER_S * 1e3,
            ops_per_cell=K2_CELL_OPS, library_ms=library_ms,
            library_note="conv2d of the padded grid, float16, (2r+1)² ones: "
                         "one generation's counts only (centre included), "
                         "no rule")
    del x
    torch.cuda.empty_cache()
    _padded_times(card, rows)
    _batched_times(card, rows)
    _sparse_times(card, rows)
    return rows


# -- phase 5: traces ---------------------------------------------------------

# the CUDA kernels of each wrapper, as their names appear in a trace
KERNEL_NAMES = {"K1": ("bit_step_kernel",),
                "K2": ("dense_step_kernel", "dense_narrow_kernel"),
                "K3": ("ltl_step_kernel",),
                "seam": ("seam_band_kernel",)}


def _trace_holds_launches(label: str, attempt):
    """The one trace rule of phases 5, 6 and 7: a traced window holds
    exactly the kernel launches the wrappers counted in it.  ``attempt()``
    traces the window once and returns ``(counted, in_trace, result)``,
    dicts of kernel id -> launches counted and kernel records in the
    trace.  More records than launches fail at once (a kernel ran
    uncounted); fewer take the window once more — the profiler drops a
    kernel's record now and then (one of 200 on one path of a whole run),
    while a launch that the code counts and does not make would be missing
    again — and fail the second time.  Returns ``(result, takes, lost)``,
    ``lost`` the records missing on a retaken attempt."""
    lost = []
    for take in (1, 2):
        counted, in_trace, result = attempt()
        if any(in_trace.get(kid, 0) > n for kid, n in counted.items()):
            fail(f"the {label} trace holds {in_trace} kernels for "
                 f"{counted} counted launches: a kernel ran uncounted")
        if all(in_trace.get(kid, 0) == n for kid, n in counted.items()):
            return result, take, lost
        lost.append({kid: n - in_trace.get(kid, 0)
                     for kid, n in counted.items()})
        print(f"chip_smoke: the {label} trace lost {lost[-1]} kernel "
              f"records; tracing again", file=sys.stderr, flush=True)
    fail(f"the {label} trace holds {in_trace} kernels for {counted} "
         f"counted launches, twice")


def _trace(card, label, size, rule, comm_every, steps,
           boundary="periodic", boards=0, board=None) -> None:
    """The steady stepping of ``run_cuda``'s engine on one main path (or of
    ``step_batched`` on a batch of ``boards``, or of the sparse Life engine
    from ``board()`` once its first generation has settled the map) under
    ``torch.profiler``, inside a ``steady`` host range opened once the
    profiler has seen one kernel: the device is busy for the union of its
    kernel intervals in that range, and idle for the rest of it.  Host
    operations that run before the first kernel say what delays it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    if board is not None:
        engine = _sparse_engine()
        grid = engine.step(activity.initial_state(board(), engine.sparse_plan),
                           1)
    else:
        cfg = GolConfig(rows=size, cols=size, steps=steps, seed=SEED,
                        rule=rule, comm_every=comm_every, boundary=boundary)
        engine = backend.build_engine(cfg)
        grid = (engine.init_grids(seeds=range(SEED, SEED + boards)) if boards
                else engine.init_grid())
    engine.warm_up(boards=boards)
    engine.sync()
    # one launch a pass of the path's kernel, and of the seam band's kernel
    # on a padded torus; the sparse path's launches follow its phases: its
    # kernel's alone
    passes = -(-steps // engine.depth)
    expected = {kid: 0 for kid in COUNTERS}
    expected[engine.kernel_id] = passes
    if engine.seam:
        expected["seam"] = passes
    reads = engine._evolve.reads if board is not None else 0
    unprofiled_ms = None
    if board is not None:
        # the profiler's own host cost per operation lengthens a host-bound
        # window: time one window without it too
        t0 = time.perf_counter()
        grid = engine.step(grid, steps)
        engine.sync()
        unprofiled_ms = (time.perf_counter() - t0) * 1e3

    def attempt():
        nonlocal grid
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            # the profiler's first kernel
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            before = {kid: w.launches for kid, w in COUNTERS.items()}
            builds = _build.builds
            with record_function("steady"):
                if boards:
                    grid = engine.step_batched(grid, steps)
                else:
                    grid = engine.step(grid, steps)
                engine.sync()
        counted = {kid: w.launches - before[kid]
                   for kid, w in COUNTERS.items()}
        if board is not None:
            expected[engine.kernel_id] = max(1, counted[engine.kernel_id])
        if counted != expected:
            fail(f"the {label} path launched {counted}, expected {expected} "
                 f"(one a pass)")
        if _build.builds != builds:
            fail(f"the {label} path built a kernel while it stepped")
        events = prof.events()
        # every counted launch is a kernel in the trace, and no kernel of
        # K1-K3 ran uncounted: the whole profile holds none outside the
        # range, so it is counted whole, free of the clocks' offset
        in_trace = {kid: sum(1 for e in events
                             if e.device_type == DeviceType.CUDA
                             and any(n in e.name for n in names))
                    for kid, names in KERNEL_NAMES.items()}
        return counted, in_trace, (events, counted, in_trace)

    (events, counted, in_trace), _, lost = _trace_holds_launches(label,
                                                                  attempt)
    launches = counted[engine.kernel_id]
    del grid
    torch.cuda.empty_cache()
    # the host's range: the profiler also puts a copy of it on the device's
    # timeline, spanning only the kernels
    steady = next(e.time_range for e in events if e.name == "steady"
                  and e.device_type == DeviceType.CPU)
    # every kernel that ends inside the range (the profiler's device clock
    # is aligned to the host's to within about a millisecond, so the first
    # kernel launched in the range may seem to start before it), clipped
    # to the range
    spans = sorted((max(e.time_range.start, steady.start), e.time_range.end,
                    e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "steady"
                   and e.time_range.end > steady.start)
    wall_us = steady.end - steady.start
    busy_us, end, by_name, gaps = 0.0, float("-inf"), {}, []
    for start, stop, name in spans:
        if end > float("-inf"):
            gaps.append(max(0.0, start - end))
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
        count, us = by_name.get(name, (0, 0.0))
        by_name[name] = (count + 1, us + stop - start)
    first = spans[0][0] if spans else steady.end
    early = sorted(((e.time_range.end - e.time_range.start, e.name)
                    for e in events if e.device_type == DeviceType.CPU
                    and e.name != "steady"
                    and steady.start <= e.time_range.start < first),
                   reverse=True)[:5]
    own = KERNEL_NAMES[engine.kernel_id][0]
    traced = sum(c for n, (c, _) in by_name.items() if own in n)
    emit({"phase": "trace", "card": card, "path": label,
          "kernel": engine.kernel_id, "grid": [size, size], "boards": boards,
          "boundary": boundary, "pad_bits": engine.pad_bits,
          "seam": engine.seam,
          # device time of every other kernel (the seam band's), by the
          # same union
          "other_kernels_ms": sum(us for n, (_, us) in by_name.items()
                                  if own not in n) / 1e3,
          "steps": steps, "comm_every": comm_every,
          "pass_depth": engine.depth, "launches": launches,
          "sparse_tile": board is not None and SPARSE_T,
          # host reads of the active count over both attempts (sparse path)
          "host_reads": (engine._evolve.reads - reads
                         if board is not None else 0),
          # the path kernel's launches the trace holds in its window, and
          # every kernel's launches, counted and in the whole trace
          "traced_launches": traced,
          "launches_by_kernel": counted, "kernels_in_trace": in_trace,
          "records_lost_on_retried_attempts": lost,
          "builds_in_window": 0,
          "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
          # None when the profiler recorded no device activity
          "idle_share": 1 - busy_us / wall_us if spans else None,
          # the sparse path: a window of the same steps without the
          # profiler, and the idle share its device time implies there
          "unprofiled_wall_ms": unprofiled_ms,
          "idle_share_unprofiled": (1 - busy_us / 1e3 / unprofiled_ms
                                    if unprofiled_ms else None),
          # where the idle time lies: before the first kernel, between
          # kernels (and the largest such gap), after the last
          "first_kernel_after_ms": (first - steady.start) / 1e3,
          "gaps_between_kernels_ms": sum(gaps) / 1e3,
          "largest_gap_ms": max(gaps, default=0.0) / 1e3,
          "after_last_kernel_ms": (steady.end - end) / 1e3 if spans else None,
          "host_ops_before_first_kernel": [
              {"name": n, "ms": us / 1e3} for us, n in early],
          "kernels": [{"name": n, "count": c, "ms": us / 1e3}
                      for n, (c, us) in sorted(by_name.items())]})


def phase5_traces(card: str) -> None:
    _trace(card, "life", FLAGSHIP, LIFE, MAIN_GENS, MAIN_STEPS)
    for label, rule, k, n in LTL_PATHS:
        _trace(card, label, FLAGSHIP, rule, k, n)
    label, rule, k, n = DENSE_PATH
    _trace(card, label, DENSE, rule, k, n)
    for label, _, _, rule, k, n, boundary in PADDED_PATHS:
        _trace(card, label, PADDED, rule, k, n, boundary)
    label, B, size, rule, k, n, _ = BATCH_PATH
    _trace(card, label, size, rule, k, n, boards=B)
    label, rule, k, n = DEEP_PATH
    _trace(card, label, DENSE, rule, k, n)
    _trace(card, "sparse_life", FLAGSHIP, LIFE, 1, SPARSE_STEPS - 1,
           board=_sparse_board)


# -- phase 6: the serve layer --------------------------------------------------

# (sessions, size, comm_every, generations a request, rounds timed, rounds
# traced): the batched path's 32 boards of 4096² Life (64 MiB), one K1
# pass a request, coalesced into one launch a round
SERVE_LIFE = (32, 4096, 8, 8, 100, 20)
# (sessions per engine, size, ticket depths, cycles): 4096² Bosco on K3
# (comm_every 1) and on K2 (comm_every 3); the depths rotate by session so
# every round mixes them, and 5 cycles pass checkpoint_every
SERVE_LTL = (8, 4096, (1, 2, 5, 8), 5)
SERVE_CHECKPOINT_EVERY = 64
# (sessions, size, generations a request, rounds): solo steps (no batcher)
# of sessions that share one 4096² Life engine, one thread each
SERVE_SOLO = (8, 4096, 8, 25)
SERVE_FAULT_SIZE = 256


def _reset_launches() -> None:
    for w in COUNTERS.values():
        w.launches = 0


def _launches() -> dict:
    return {kid: w.launches for kid, w in KERNELS.items()}


def _counted() -> dict:
    """:func:`_launches` and the seam band's launches."""
    return {kid: w.launches for kid, w in COUNTERS.items()}


def _serve_rounds(mgr, sids, rounds: int, n: int) -> float:
    """``rounds`` requests of ``n`` generations from one thread a session,
    all started together; the wall seconds."""
    errors, barrier = [], threading.Barrier(len(sids))

    def run(sid):
        try:
            barrier.wait()
            for _ in range(rounds):
                mgr.step(sid, n)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in sids]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving failed: {errors[:3]}")
    return wall


def _no_faults(mgr, label: str) -> None:
    batch = mgr.stats().get("batch", {})
    counts = {"batched_fallbacks": batch.get("batched_fallbacks", 0),
              "async_batched_fallbacks": mgr.dispatcher.batched_fallbacks,
              "engine_failures": mgr.engine_failures,
              "degraded_total": mgr.degraded_total}
    if any(counts.values()):
        fail(f"the {label} serving fell back or failed: {counts}")


def _serve_trace(fn):
    """Run ``fn`` under ``torch.profiler`` inside a ``serve`` range: the
    range's wall ms, the union of its kernels' intervals (busy ms), and the
    count and summed ms of K1's kernels in the whole trace.  Only ``fn``
    launches K1 there, and the profiler places a kernel up to milliseconds
    before its launch (phase 7's ``kernel_placement``), so a K1 kernel that
    ``fn`` launched at once can sit before the range's start."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function("serve"):
            fn()
            torch.cuda.synchronize()
    events = prof.events()
    window = next(e.time_range for e in events if e.name == "serve"
                  and e.device_type == DeviceType.CPU)
    spans = sorted((max(e.time_range.start, window.start), e.time_range.end,
                    e.name) for e in events
                   if e.device_type == DeviceType.CUDA and e.name != "serve"
                   and e.time_range.end > window.start)
    busy, end = 0.0, float("-inf")
    for start, stop, _ in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    k1 = [e.time_range.end - e.time_range.start for e in events
          if e.device_type == DeviceType.CUDA
          and KERNEL_NAMES["K1"][0] in e.name]
    return {"wall_ms": (window.end - window.start) / 1e3,
            "busy_ms": busy / 1e3, "k1_kernels": len(k1),
            "k1_ms": sum(k1) / 1e3}


def _serve_life(card: str, times: dict) -> None:
    """Part 1 (coalesced Life sessions on K1), part 5 (the wait truly
    waits) and part 6 (the per-layer numbers)."""
    B, size, k, n, rounds, traced = SERVE_LIFE
    mgr = SessionManager(EngineCache(), batch_max=B)
    spec = {"rows": size, "cols": size, "rule": "life", "comm_every": k,
            "segments": [1, k]}
    infos = [mgr.create(dict(spec, seed=SEED + b)) for b in range(B)]
    if [i["cache_hit"] for i in infos] != [False] + [True] * (B - 1):
        fail("the Life sessions' creates were not one miss and hits")
    if {i["engine_compiles"] for i in infos} != {infos[0]["engine_compiles"]}:
        fail("a cache hit compiled")
    sids = [i["id"] for i in infos]
    engine = mgr.get(sids[0]).engine
    _serve_rounds(mgr, sids, 1, n)      # warms the (n, B) batched step
    builds = _build.builds

    def steps_and_warmups(st0, c0):
        # a step is one K1 launch (one pass); a batch width met for the
        # first time (a round that split) warms its depth once: one more
        st1 = mgr.batcher.stats()
        return (st1["coalesced_calls"] - st0["coalesced_calls"]
                + st1["solo_steps"] - st0["solo_steps"],
                engine.compile_count - c0, st1)

    st0, c0 = mgr.batcher.stats(), engine.compile_count
    steady0 = [mgr.get(s).steady_s for s in sids]
    _reset_launches()
    cpu0 = time.process_time()
    wall = _serve_rounds(mgr, sids, rounds, n)
    cpu = time.process_time() - cpu0
    launches = _launches()
    calls, warmups, st1 = steps_and_warmups(st0, c0)
    if launches != {"K1": calls + warmups, "K2": 0, "K3": 0} or not calls:
        fail(f"coalesced serving launched {launches} for {calls} steps and "
             f"{warmups} warm-ups (one K1 launch each)")
    boards = st1["batched_boards"] - st0["batched_boards"]
    # part 5: the layer's own step time against the kernels' own, in a
    # trace that holds every counted K1 launch (phase 5's rule: one more
    # take when the profiler lost a record, never a looser count)
    steady_after_rounds = [mgr.get(s).steady_s for s in sids]

    def attempt():
        s0, c0 = mgr.batcher.stats(), engine.compile_count
        steady1 = [mgr.get(s).steady_s for s in sids]
        _reset_launches()
        trace = _serve_trace(lambda: _serve_rounds(mgr, sids, traced, n))
        traced_launches = _launches()["K1"]
        traced_calls, traced_warmups, s1 = steps_and_warmups(s0, c0)
        if _build.builds != builds:
            fail("a kernel was built while the sessions were served")
        if traced_launches != traced_calls + traced_warmups:
            fail(f"the traced serving counted {traced_launches} K1 launches "
                 f"for {traced_calls} steps and {traced_warmups} warm-ups")
        return ({"K1": traced_launches}, {"K1": trace["k1_kernels"]},
                (s0, s1, steady1, trace, traced_launches, traced_calls))

    (s0, s1, steady1, trace, traced_launches, traced_calls), takes, _ = \
        _trace_holds_launches("serve", attempt)
    layer_s = (s1["batched_step_s"] - s0["batched_step_s"]
               + s1["solo_step_s"] - s0["solo_step_s"])
    steady = [mgr.get(s).steady_s - t for s, t in zip(sids, steady1)]
    whole = (s1["coalesced_calls"] - s0["coalesced_calls"] == traced
             and s1["batched_boards"] - s0["batched_boards"] == B * traced)
    if layer_s * 1e3 < trace["k1_ms"]:
        fail(f"the serve layer's step time {layer_s * 1e3} ms is below its "
             f"K1 kernels' {trace['k1_ms']} ms: the wait did not wait")
    if whole and min(steady) * 1e3 < trace["k1_ms"]:
        fail(f"a session's steady_s ({min(steady) * 1e3} ms) is below the "
             f"K1 kernels it waited for ({trace['k1_ms']} ms)")
    _no_faults(mgr, "Life")
    total = n * (1 + rounds + traced * takes)
    if any(mgr.get(s).generation != total for s in sids):
        fail("a Life session lost a step")
    # step_batched alone on the same boards, same generations: the
    # boards must equal the sessions', and the plain version's (two)
    ref = engine.init_grids(seeds=[SEED + b for b in range(B)])
    engine.sync()
    t0 = time.perf_counter()
    ref = engine.step_batched(ref, total)
    engine.sync()
    alone_s = time.perf_counter() - t0
    got = torch.stack([mgr.get(s).grid for s in sids])
    if not torch.equal(got, ref):
        fail("the served Life boards differ from step_batched's")
    plain = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                         for b in (0, B - 1)])
    plain = bit_step_plain(plain, LIFE, "periodic", 1)
    for _ in range(total - 1):
        plain = bit_step_plain(plain, LIFE, "periodic", 1)
    if not (torch.equal(got[0], plain[0]) and torch.equal(got[-1], plain[1])):
        fail("the served Life boards differ from the plain version's")
    phase4_ms = times["K1", "batched"]["ms"]
    times["serve", "requests_per_s"] = B * rounds / wall   # phase 8's base
    emit({"phase": "serve", "part": "coalesced_life", "card": card,
          "kernel": "K1", "sessions": B, "grid": [size, size],
          "comm_every": k, "generations_a_request": n, "rounds": rounds,
          "cache": mgr.cache.stats(),
          "engine_compiles": engine.compile_count,
          "engine_batched_compiles": engine.batched_compile_count,
          "compile_wall_s": engine.compile_wall_s,
          "launches": launches, "steps": calls, "warmups": warmups,
          "avg_occupancy": boards / max(1, st1["coalesced_calls"]
                                        - st0["coalesced_calls"]),
          "solo_steps": st1["solo_steps"] - st0["solo_steps"],
          "boards_equal_to_step_batched_and_plain": True,
          "builds_while_serving": 0,
          "serving_wall_s": wall,
          "serving_board_generations_per_s": B * n * rounds / wall,
          "step_batched_board_generations_per_s": B * total / alone_s,
          "requests_per_s": B * rounds / wall,
          "host_cpu_ms_per_request": cpu * 1e3 / (B * rounds),
          "steady_s_over_rounds": {"min": min(s - t for s, t in
                                              zip(steady_after_rounds, steady0)),
                                   "max": max(s - t for s, t in
                                              zip(steady_after_rounds, steady0))},
          "phase4_k1_batched_ms_per_pass": phase4_ms,
          "min_steady_over_phase4_kernel_time":
              min(s - t for s, t in zip(steady_after_rounds, steady0)) * 1e3
              / (rounds * phase4_ms)})
    emit({"phase": "serve", "part": "trace", "card": card, "rounds": traced,
          "takes": takes,
          "every_round_coalesced": whole, "k1_launches": traced_launches,
          "steps": traced_calls, **trace,
          "idle_share": 1 - trace["busy_ms"] / trace["wall_ms"],
          "layer_step_ms": layer_s * 1e3,
          "min_session_steady_ms": min(steady) * 1e3,
          "layer_step_over_k1_ms": layer_s * 1e3 / trace["k1_ms"]})
    mgr.shutdown()
    del ref, got, plain
    torch.cuda.empty_cache()


def _serve_solo_threads(card: str) -> None:
    """Sessions sharing one engine step solo (``batching=False``) from one
    thread each: their launches interleave on the engine's ping-pong spare,
    and every board must equal the plain version's."""
    B, size, n, rounds = SERVE_SOLO
    mgr = SessionManager(EngineCache(), batching=False)
    sids = [mgr.create({"rows": size, "cols": size, "rule": "life",
                        "comm_every": n, "segments": [n],
                        "seed": SEED + b})["id"] for b in range(B)]
    engine = mgr.get(sids[0]).engine
    if any(mgr.get(s).engine is not engine for s in sids):
        fail("the solo Life sessions do not share one engine")
    _reset_launches()
    wall = _serve_rounds(mgr, sids, rounds, n)
    launches = _launches()
    if (launches != {"K1": B * rounds, "K2": 0, "K3": 0}
            or engine.batched_step_calls):
        fail(f"{B * rounds} solo steps launched {launches} "
             f"({engine.batched_step_calls} batched steps)")
    _no_faults(mgr, "solo Life")
    got = torch.stack([mgr.get(s).grid for s in sids])
    plain = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                         for b in range(B)])
    for _ in range(n * rounds):
        plain = bit_step_plain(plain, LIFE, "periodic", 1)
    if not torch.equal(got, plain):
        bad = [b for b in range(B) if not torch.equal(got[b], plain[b])]
        fail(f"the solo boards {bad} stepped from {B} threads on one "
             f"engine differ from the plain version's")
    emit({"phase": "serve", "part": "solo_threads", "card": card,
          "kernel": "K1", "sessions": B, "threads": B, "grid": [size, size],
          "generations_a_request": n, "rounds": rounds,
          "launches": launches, "serving_wall_s": wall,
          "boards_equal_to_plain": True})
    mgr.shutdown()
    del got, plain
    torch.cuda.empty_cache()


def _ltl_plain(kid: str, size: int, seeds, gens: int) -> torch.Tensor:
    """The plain version's boards of 4096² Bosco after ``gens``
    generations: packed words stepped by K3's plain version, or cells by
    K2's."""
    if kid == "K3":
        x = torch.stack([init_packed(size, size, s, device="cuda")
                         for s in seeds])
        for _ in range(gens):
            x = ltl_step_plain(x, BOSCO, "periodic", 1)
        return x
    x = torch.stack([init_dense(size, size, s, device="cuda") for s in seeds])
    for g in [3] * (gens // 3) + [gens % 3] * bool(gens % 3):
        x = dense_step_plain(x, BOSCO, "periodic", g)
    return x


def _ltl_sessions(mgr, per: int, size: int) -> dict:
    """``per`` sessions of Bosco at ``size``² on K3 (comm_every 1) and
    ``per`` on K2 (comm_every 3), seeds SEED, SEED + 1, ...: kernel -> sids."""
    sids = {kid: [mgr.create({"rows": size, "cols": size, "rule": "bosco",
                              "comm_every": k, "seed": SEED + i})["id"]
                  for i in range(per)] for kid, k in (("K3", 1), ("K2", 3))}
    for kid, ids in sids.items():
        if mgr.get(ids[0]).engine.kernel_id != kid:
            fail(f"the Bosco sessions meant for {kid} took another engine")
    return sids


def _ticket_cycle(mgr, sids: list, depths) -> None:
    """One ticket of each depth for every session, the depths rotated by
    session so every round mixes them; waits for all."""
    out = [mgr.step_async(sid, d) for i, sid in enumerate(sids)
           for d in depths[i % len(depths):] + depths[:i % len(depths)]]
    for t in out:
        r = mgr.ticket_result(t["ticket"], wait=True, timeout_s=600)
        if r["status"] != "done":
            fail(f"a ticket did not finish: {r}")


def _serve_ltl(card: str, state_dir: str) -> None:
    """Part 2 (LtL sessions through tickets on K3 and K2, with no state
    dir: the serving alone) and part 3 (the same with a state dir, then
    a restore)."""
    per, size, depths, cycles = SERVE_LTL
    mgr = SessionManager(EngineCache())
    sids = _ltl_sessions(mgr, per, size)
    every = sids["K3"] + sids["K2"]
    _ticket_cycle(mgr, every, depths)   # warms the batch widths a cycle meets
    engines = [mgr.get(ids[0]).engine for ids in sids.values()]
    builds = _build.builds
    st0 = mgr.dispatcher.stats()
    c0 = sum(e.compile_count for e in engines)
    _reset_launches()
    t0 = time.perf_counter()
    for _ in range(cycles - 1):
        _ticket_cycle(mgr, every, depths)
    wall = time.perf_counter() - t0
    launches = _launches()
    st1 = mgr.dispatcher.stats()
    # one launch a unit round of a chain, and one a batch width warmed
    unit_rounds = st1["unit_rounds"] - st0["unit_rounds"]
    warmups = sum(e.compile_count for e in engines) - c0
    if (launches["K1"] or not launches["K3"] or not launches["K2"]
            or launches["K3"] + launches["K2"] != unit_rounds + warmups
            or st1["solo_tickets"] != st0["solo_tickets"]):
        fail(f"the ticket rounds launched {launches} for {unit_rounds} "
             f"unit rounds and {warmups} warm-ups")
    if _build.builds != builds:
        fail("a kernel was built while the tickets were served")
    _no_faults(mgr, "ticket")
    gens = cycles * sum(depths)
    for kid, ids in sids.items():
        want = _ltl_plain(kid, size, [SEED + i for i in range(per)], gens)
        if not torch.equal(torch.stack([mgr.get(s).grid for s in ids]),
                           want):
            fail(f"the {kid} ticket sessions' boards differ from the plain "
                 f"version's")
    del want
    emit({"phase": "serve", "part": "tickets", "card": card,
          "sessions": {kid: per for kid in sids}, "grid": [size, size],
          "rule": "bosco", "comm_every": {"K3": 1, "K2": 3},
          "depths": list(depths), "cycles": cycles, "generations": gens,
          "launches": launches, "unit_rounds": unit_rounds,
          "warmups": warmups, "rounds": st1["group_dispatches"]
          - st0["group_dispatches"], "max_occupancy": st1["max_occupancy"],
          "wall_s": wall, "board_generations_per_s":
              2 * per * (cycles - 1) * sum(depths) / wall,
          "boards_equal_to_plain": True, "builds_while_serving": 0})
    # part 3: the same tickets with a state dir; a second manager restores
    # from a copy of it, so the first can step on without writing into the
    # second's records
    durable = SessionManager(EngineCache(), state_dir=state_dir,
                             checkpoint_every=SERVE_CHECKPOINT_EVERY)
    if _ltl_sessions(durable, per, size) != sids:
        fail("the durable manager's session ids differ")
    t0 = time.perf_counter()
    for _ in range(cycles):
        _ticket_cycle(durable, every, depths)
    durable_s = time.perf_counter() - t0
    for sid in every:
        if not torch.equal(durable.get(sid).grid, mgr.get(sid).grid):
            fail(f"session {sid} with a state dir differs from without")
    mgr.shutdown()
    durable.shutdown()
    _no_faults(durable, "durable ticket")
    copy = state_dir + "_restored"
    shutil.copytree(state_dir, copy)
    t0 = time.perf_counter()
    restored = SessionManager(EngineCache(), state_dir=copy,
                              checkpoint_every=SERVE_CHECKPOINT_EVERY)
    restore_s = time.perf_counter() - t0
    snaps = [rec.get("snapshot") for rec in restored.store.load_records()]
    if (restored.restored_sessions != len(every) or restored.restore_errors
            or not all(snaps)):
        fail(f"restored {restored.restored_sessions} of {len(every)} "
             f"sessions ({restored.restore_errors} errors, "
             f"{sum(map(bool, snaps))} snapshots)")
    for sid in every:
        if not torch.equal(restored.get(sid).grid, durable.get(sid).grid):
            fail(f"restored session {sid} differs from the one it restores")
    for m in (durable, restored):
        for sid in every:
            m.step(sid, 3)
    for sid in every:
        if not torch.equal(restored.get(sid).grid, durable.get(sid).grid):
            fail(f"restored session {sid} and its original diverged")
    _no_faults(restored, "restored")
    store = durable.store.stats()
    emit({"phase": "serve", "part": "restore", "card": card,
          "sessions": len(every), "checkpoint_every": SERVE_CHECKPOINT_EVERY,
          "durable_cycles": cycles, "durable_wall_s": durable_s,
          "durable_board_generations_per_s":
              2 * per * cycles * sum(depths) / durable_s,
          "store": {k: store[k] for k in ("writes", "write_s",
                                          "snapshot_writes",
                                          "journal_appends", "bytes_full",
                                          "bytes_delta", "compactions")},
          "snapshot_generations": sorted({s["generation"] for s in snaps}),
          "restored_generation": gens, "restore_s": restore_s,
          "bit_identical": True, "equal_after_3_more": True})
    restored.shutdown()
    torch.cuda.empty_cache()


def _serve_faults(card: str) -> None:
    """Part 4: injected faults at 256²."""
    size, n = SERVE_FAULT_SIZE, 8
    spec = {"rows": size, "cols": size, "comm_every": n, "segments": [n]}

    def oracle(seed, gens):
        return evolve_np(init_tile_np(size, size, seed), gens, LIFE,
                         "periodic")

    def board(mgr, sid):
        return mgr.snapshot_array(sid)[0]

    out = {}
    mgr = SessionManager(faults="step:1:raise", step_retries=2,
                         retry_backoff_s=0.001, batching=False)
    sid = mgr.create(dict(spec, seed=7))["id"]
    if (mgr.step(sid, n)["generation"] != n or mgr.engine_failures != 1
            or not np.array_equal(board(mgr, sid), oracle(7, n))):
        fail("a transient fault did not retry to the oracle's board")
    out["transient"] = {"engine_failures": mgr.engine_failures}
    mgr.shutdown()

    mgr = SessionManager(faults="step:1:delay:2.0", request_timeout_s=0.5,
                         step_retries=0, batching=False)
    sid = mgr.create(dict(spec, seed=8))["id"]
    try:
        mgr.step(sid, n)
        fail("a step delayed past its deadline returned")
    except DeadlineError:
        pass
    mgr.shutdown()                      # joins the abandoned worker
    gen = mgr.get(sid).generation       # the late step commits
    mgr.step(sid, n)
    if not np.array_equal(board(mgr, sid), oracle(8, gen + n)):
        fail("the session behind a missed deadline lost its board")
    out["deadline"] = {"watchdog_timeouts": mgr.watchdog_timeouts,
                       "generation_after": gen + n}

    mgr = SessionManager(EngineCache(breaker_threshold=3,
                                     breaker_cooldown_s=600.0),
                         faults="step:1-3:raise", step_retries=2,
                         retry_backoff_s=0.001, batching=False)
    sid = mgr.create(dict(spec, seed=9))["id"]
    mgr.step(sid, n)
    s = mgr.get(sid)
    if not (s.degraded and s.engine is None and mgr.degraded_total == 1):
        fail("the breaker did not degrade the session")
    mgr.step(sid, n)
    if not np.array_equal(board(mgr, sid), oracle(9, 2 * n)):
        fail("the degraded session's board differs from the oracle's")
    out["breaker"] = {"trips": mgr.cache.breaker_stats()["trips"],
                      "degraded_total": mgr.degraded_total}
    mgr.shutdown()

    # a real failure of a card engine (here its fault hook raising before
    # any launch) opens the breaker and never moves the session to the CPU
    mgr = SessionManager(EngineCache(breaker_threshold=3,
                                     breaker_cooldown_s=600.0),
                         step_retries=2, retry_backoff_s=0.001,
                         batching=False)
    sid = mgr.create(dict(spec, seed=10))["id"]
    s = mgr.get(sid)

    def broken(site):
        raise RuntimeError(f"{site} dispatch failed")

    s.engine.fault_hook = broken
    try:
        mgr.step(sid, n)
        fail("a step of a failing card engine returned")
    except EngineUnavailableError:
        pass
    if (mgr.get(sid) is not s or s.degraded or s.engine is None
            or mgr.degraded_total or s.grid.device.type != "cuda"):
        fail("a real engine failure moved the card session to the CPU")
    try:
        mgr.create(dict(spec, seed=11))
        fail("a create on the failed card plan returned a session")
    except EngineUnavailableError:
        pass
    out["card_failure"] = {"engine_failures": mgr.engine_failures,
                           "degraded_total": mgr.degraded_total}
    mgr.shutdown()
    emit({"phase": "serve", "part": "faults", "card": card,
          "grid": [size, size], **out, "boards_equal_to_oracle": True})


def phase6_serve(card: str, times: dict) -> None:
    _serve_life(card, times)
    _serve_solo_threads(card)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        _serve_ltl(card, os.path.join(d, "state"))
    _serve_faults(card)


# -- phase 7: observability and the native backends ---------------------------

# (sessions, size, comm_every, generations a request, rounds a turn): the
# Life sessions of each manager (obs off, obs on), 32 boards of 4096² as
# in phase 6, beside one 4096² Bosco session on K3 and one on K2
OBS_LIFE = (32, 4096, 8, 8, 20)
OBS_LTL_SIZE = 4096
# run_profile's capture, the wait inside it before the traffic starts, and
# the traffic.  Inside the capture the profiler's first kernel comes first
# (phases 5 and 6 launch one too): the record of the first kernel launched
# in a capture can be missing from the trace, and the counted traffic must
# not hold it.  The counted launches also lie half a second from either
# edge of the capture, as the trace places a kernel up to milliseconds
# off the host call that launched it, before it or after
OBS_PROFILE_S, OBS_LEAD_S, OBS_TRAFFIC_S = 2.0, 0.5, 1.0
# (size, generations, cpp-par workers) of the native backends' runs
NATIVE = (2048, 20, 8)


def _obs_sessions(mgr) -> dict:
    """The sessions of phase 7 on ``mgr``: 32 of Life (K1), one of Bosco on
    K3 (comm_every 1) and one on K2 (comm_every 3)."""
    B, size, k, _, _ = OBS_LIFE
    life = [mgr.create({"rows": size, "cols": size, "rule": "life",
                        "comm_every": k, "segments": [1, k],
                        "seed": SEED + b})["id"] for b in range(B)]
    ltl = {kid: mgr.create({"rows": OBS_LTL_SIZE, "cols": OBS_LTL_SIZE,
                            "rule": "bosco", "comm_every": ce,
                            "seed": SEED})["id"]
           for kid, ce in (("K3", 1), ("K2", 3))}
    for kid, sid in [("K1", life[0]), *ltl.items()]:
        if mgr.get(sid).engine.kernel_id != kid:
            fail(f"a phase 7 session meant for {kid} took another engine")
    return {"life": life, **ltl}


def _obs_traffic(mgr, sids: dict, rounds: int) -> float:
    """``rounds`` coalesced Life rounds (the wall seconds, the requests/s
    measure), then one step of each Bosco session (K3 two generations, K2
    three)."""
    wall = _serve_rounds(mgr, sids["life"], rounds, OBS_LIFE[3])
    mgr.step(sids["K3"], 2)
    mgr.step(sids["K2"], 3)
    return wall


def _kernel_placement(events: list, kernels: list) -> dict:
    """Where a Chrome trace puts its kernels against the host calls that
    launched them (paired by ``correlation``), in µs from the trace's
    first event: the kernel's start less its launch's (least, median,
    most: negative means the device's clock, as converted, runs early),
    the first launch and the last kernel's end, and every launch call
    whose kernel the trace lacks."""
    t0 = min(e["ts"] for e in events if "ts" in e)
    start = {e["args"]["correlation"]: e["ts"] for e in kernels
             if "correlation" in e.get("args", {})}
    calls = [e for e in events
             if e.get("cat") in ("cuda_runtime", "cuda_driver")
             and "LaunchKernel" in e.get("name", "")]
    offsets = sorted(start[c] - e["ts"] for e in calls
                     if (c := e.get("args", {}).get("correlation")) in start)
    return {"kernel_minus_launch_us": (
                [offsets[0], offsets[len(offsets) // 2], offsets[-1]]
                if offsets else None),
            "first_launch_us": min((e["ts"] - t0 for e in calls),
                                   default=None),
            "last_kernel_end_us": max((e["ts"] + e.get("dur", 0) - t0
                                       for e in kernels), default=None),
            "trace_span_us": max(e["ts"] for e in events if "ts" in e) - t0,
            "launches_without_kernel": [
                {"name": e["name"], "at_us": e["ts"] - t0}
                for e in calls if e.get("args", {}).get("correlation")
                not in start]}


def _obs_profile(mgr, sids: dict, logdir: str) -> dict:
    """One ``run_profile`` capture over about a second of Life traffic,
    started ``OBS_LEAD_S`` after the capture's first kernel: the K1
    launches counted inside the capture against the K1 kernel records of
    the Chrome trace it wrote (the trace rule), and where the trace placed
    its kernels."""
    n = OBS_LIFE[3]

    def attempt():
        out = {}
        t = threading.Thread(
            target=lambda: out.update(run_profile(logdir, OBS_PROFILE_S)))
        t.start()
        if not capturing.wait(60):
            fail("run_profile's capture did not start")
        # the profiler's first kernel
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(OBS_LEAD_S)
        _reset_launches()
        t0, rounds = time.perf_counter(), 0
        while time.perf_counter() - t0 < OBS_TRAFFIC_S:
            _serve_rounds(mgr, sids["life"], 1, n)
            rounds += 1
        torch.cuda.synchronize()
        counted = _launches()
        if not capturing.is_set():
            fail("the profiled traffic outlasted run_profile's capture")
        t.join(120)
        if t.is_alive() or not out.get("ok"):
            fail(f"run_profile failed: {out}")
        with open(out["path"]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        in_trace = {kid: sum(1 for e in kernels
                             if any(nm in e.get("name", "") for nm in names))
                    for kid, names in KERNEL_NAMES.items()}
        if counted["K2"] or counted["K3"] or not counted["K1"]:
            fail(f"the profiled Life traffic launched {counted}")
        placement = _kernel_placement(events, kernels)
        if placement["launches_without_kernel"]:
            print(f"chip_smoke: run_profile's launches without a kernel "
                  f"record: {placement}", file=sys.stderr, flush=True)
        return ({"K1": counted["K1"]}, {"K1": in_trace["K1"]},
                {"rounds": rounds, "k1_launches": counted["K1"],
                 "trace_kernels": in_trace, "trace_events": len(events),
                 "trace_bytes": os.path.getsize(out["path"]),
                 "capture_s": out["seconds"], "lead_s": OBS_LEAD_S,
                 "kernel_placement": placement})

    result, takes, lost = _trace_holds_launches("run_profile", attempt)
    return {**result, "takes": takes, "records_lost_on_retaken": lost}


def _check_cards(engines: dict) -> dict:
    """Every engine holds a card for each (depth, B) it warmed, from its
    kernel's count; K1's, K3's and K2's equal their counts times the work."""
    B, size, k, _, _ = OBS_LIFE
    out = {}
    for kid, eng in engines.items():
        cards = {(c.depth, c.batch): c for c in eng.cost_cards()}
        warmed = {(n, 0) for n in eng._compiled} | set(eng._compiled_batched)
        if not cards or set(cards) != warmed:
            fail(f"{kid}'s cost cards {sorted(cards)} are not its warmed "
                 f"steps {sorted(warmed)}")
        if any(c.source != "kernel_count" or c.flops <= 0
               or c.bytes_accessed <= 0 for c in cards.values()):
            fail(f"{kid} has a cost card without its kernel's counts")
        out[kid] = [c.as_dict() for c in cards.values()]
    words = size * size // WORD
    batched = max(c.batch for c in engines["K1"].cost_cards())
    want = {"K1": [((k, 0), word_ops(LIFE) * words * k),
                   ((k, batched), word_ops(LIFE) * words * k * batched)],
            "K3": [((1, 0), ltl_word_ops(BOSCO, "row_first")
                    * OBS_LTL_SIZE ** 2 // WORD)],
            "K2": [((3, 0), dense_cell_ops(5) * OBS_LTL_SIZE ** 2 * 3)]}
    for kid, keys in want.items():
        for key, ops in keys:
            card = engines[kid].cost_card(*key)
            if card is None or card.flops != ops:
                fail(f"{kid}'s {key} card counts {card and card.flops} "
                     f"instructions, its kernel's count gives {ops}")
    return out


def phase7_obs(card: str) -> None:
    """Observability on the card, then the native backends on its host."""
    B, size, k, n, rounds = OBS_LIFE
    off = SessionManager(EngineCache(), batch_max=B)
    obs = Obs()
    on = SessionManager(EngineCache(), batch_max=B, obs=obs)
    obs.arm_telemetry(manager=on, start=False)
    obs.arm_flight(manager=on, anomaly=True)
    sids = {"off": _obs_sessions(off), "on": _obs_sessions(on)}
    if sids["off"] != sids["on"]:
        fail("the obs-on and obs-off managers' session ids differ")
    sids = sids["on"]
    for mgr in (off, on):
        _obs_traffic(mgr, sids, 1)      # warms the (n, B) batched step
    builds = _build.builds
    # turns: off, on, on, off; the obs-on run is this phase's own path,
    # its counts set to 0 just before and read just after
    walls = {"off": [], "on": []}
    for label in ("off", "on", "on", "off"):
        mgr = on if label == "on" else off
        _reset_launches()
        walls[label].append(_obs_traffic(mgr, sids, rounds))
        launches = _launches()
        if not all(launches.values()):
            fail(f"the obs-{label} traffic launched {launches}")
        if label == "on":
            on_launches = launches
    if _build.builds != builds:
        fail("a kernel was built while phase 7 served")
    for label, mgr in (("off", off), ("on", on)):
        _no_faults(mgr, f"obs-{label}")
    requests = B * rounds
    rps = {label: [requests / w for w in ws] for label, ws in walls.items()}
    emit({"phase": "obs", "part": "requests_per_s", "card": card,
          "sessions": B, "grid": [size, size], "comm_every": k,
          "generations_a_request": n, "rounds_a_turn": rounds,
          "turns": ["off", "on", "on", "off"],
          "requests_per_s": rps,
          "on_over_off": (sum(rps["on"]) / len(rps["on"]))
          / (sum(rps["off"]) / len(rps["off"])),
          "launches_obs_on": on_launches})
    # the same requests on both managers: the boards, bit for bit
    every = sids["life"] + [sids["K3"], sids["K2"]]
    for sid in every:
        a, b = off.get(sid), on.get(sid)
        if a.generation != b.generation or not torch.equal(a.grid, b.grid):
            fail(f"session {sid} with obs on differs from obs off")
    engines = {kid: on.get(sid).engine for kid, sid in
               (("K1", sids["life"][0]), ("K3", sids["K3"]),
                ("K2", sids["K2"]))}
    cards = _check_cards(engines)
    roof = roof_ops_per_s()
    props = torch.cuda.get_device_properties(0)
    if roof is None or roof != device_roof_ops_per_s():
        fail(f"no roof from the card's properties: {roof}")
    usage = on.usage()
    rooflines = {row["signature"]: row.get("roofline")
                 for row in usage["signatures"]}
    life_row = rooflines.get(engines["K1"].sig_label)
    if life_row is None:
        fail("the usage readout has no roofline for the Life signature")
    emit({"phase": "obs", "part": "cost_cards", "card": card,
          "roof_ops_per_s": roof, "sm_count": props.multi_processor_count,
          "int32_lanes_per_sm": 64,
          "clock_hz": roof / (props.multi_processor_count * 64),
          "cards": cards, "rooflines": rooflines,
          "usage_totals": usage["totals"]})
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        prof = _obs_profile(on, sids, d)
    obs.telemetry.sample_once()         # the devmem sample and the anomaly
    mem = read_device_memory()
    if not mem.get(("cuda:0", "in_use")) or not obs.devmem.memory_total():
        fail(f"read_device_memory reports no memory in use: {mem}")
    stats = on.stats()["obs"]
    if stats["flight"]["recorded"] <= 0 or on.slo()["evals"] < 1:
        fail(f"the flight recorder or SLO engine saw nothing: {stats}")
    emit({"phase": "obs", "part": "profile_devmem", "card": card, **prof,
          "device_memory": {f"{dev}/{kind}": v
                            for (dev, kind), v in sorted(mem.items())},
          "obs_stats": stats, "health_slo": on.health().get("slo")})
    # a cpp-par session of the same spec as a cuda one: equal boards
    nsize, ngens, workers = NATIVE
    spec = {"rows": nsize, "cols": nsize, "seed": SEED}
    pair = {b: on.create(dict(spec, backend=b))["id"]
            for b in ("cuda", "cpp-par")}
    for sid in pair.values():
        on.step(sid, ngens)
    if not np.array_equal(on.snapshot_array(pair["cuda"])[0],
                          on.snapshot_array(pair["cpp-par"])[0]):
        fail("a cpp-par session differs from the cuda session of its spec")
    if on.get(pair["cpp-par"]).engine is not None:
        fail("the cpp-par session holds an engine")
    off.shutdown()
    on.shutdown()
    obs.close()
    torch.cuda.empty_cache()
    _native_cli(card)


def _native_cli(card: str) -> None:
    """The CLI's native backends on the card's host against ``--backend
    cuda``: equal boards read back with ``golio``, equal master headers but
    for ``cpp-par``'s tile count."""
    size, gens, workers = NATIVE
    runs = (("cuda", []), ("cpp", []),
            ("cpp-par", ["--workers", str(workers)]))
    out = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        for b, extra in runs:
            name = b.replace("-", "_")
            t0 = time.perf_counter()
            rc = cli_main([str(size), str(size), str(gens), str(gens),
                           "--backend", b, *extra, "--save", "--name", name,
                           "--seed", str(SEED), "--out-dir", d, "--quiet"])
            if rc != 0:
                fail(f"the CLI with --backend {b} exited {rc}")
            out[b] = {"wall_s": time.perf_counter() - t0,
                      "header": golio.read_master(golio.master_path(d, name)),
                      "grids": [golio.load_snapshot(d, name, it)
                                for it in (0, gens)]}
        tiles = plan_tiles((size, size), workers, 1)
        for b in ("cpp", "cpp-par"):
            if not all(np.array_equal(x, y) for x, y in
                       zip(out[b]["grids"], out["cuda"]["grids"])):
                fail(f"--backend {b} wrote another board than --backend cuda")
        head = out["cuda"]["header"]
        if out["cpp"]["header"] != head:
            fail(f"the cpp and cuda headers differ: {out['cpp']['header']} "
                 f"{head}")
        par = out["cpp-par"]["header"]
        if (par[4] != tiles[0] * tiles[1] or par[4] == head[4]
                or par[:4] != head[:4]):
            fail(f"the cpp-par header {par} is not the cuda header with "
                 f"{tiles} tiles")
    emit({"phase": "obs", "part": "native_cli", "card": card,
          "grid": [size, size], "generations": gens, "workers": workers,
          "tiles": list(tiles),
          "headers": {b: list(r["header"]) for b, r in out.items()},
          "wall_s": {b: r["wall_s"] for b, r in out.items()},
          "boards_equal": True})


# -- phase 8: the network front on the card -----------------------------------

# (sessions, size, comm_every, generations a request, rounds timed): 32
# client threads, each on one keep-alive connection to the threaded front,
# one 4096² Life session each (phase 6's boards), one warm-up round first
FRONT_LIFE = (32, 4096, 8, 8, 20)
# the profile endpoint's capture (POST /debug/profile?secs=...), with phase
# 7's lead and traffic inside it
FRONT_PROFILE_S = 2.0
# (sessions per engine, size, ticket depths, counted cycles): Bosco on K3
# (comm_every 1) and K2 (comm_every 3) behind the aio front, tickets read
# by parked waiters (GET /result/<t>?wait=1), one warm-up cycle first
FRONT_LTL = (4, 4096, (1, 2, 5, 8), 2)
# frames a stream must push, one a generation, each held to the plain board
FRONT_FRAMES = 8
# (size, k, m): a 4096² Bosco session on K3 stepped k times in a server
# process, SIGKILLed, restored by a second process, stepped m more
FRONT_RESTART = (4096, 5, 3)
FRONT_WAIT_S = 300.0        # the limit of every wait for a server


def _http(conn, method: str, path: str, body=None, headers=None):
    """One request on a keep-alive connection: (status, headers, bytes)."""
    data = body if isinstance(body, bytes) or body is None \
        else json.dumps(body).encode()
    conn.request(method, path, body=data, headers=dict(headers or {}))
    resp = conn.getresponse()
    raw = resp.read()
    return resp.status, dict(resp.getheaders()), raw


def _http_json(conn, method: str, path: str, body=None, headers=None,
               want: int = 200):
    status, _, raw = _http(conn, method, path, body, headers)
    if status != want:
        fail(f"{method} {path} answered {status}, not {want}: {raw[:300]!r}")
    return json.loads(raw)


def _connect(address):
    return http.client.HTTPConnection(*address[:2], timeout=FRONT_WAIT_S)


def _serving(server) -> threading.Thread:
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return thread


def _stop_serving(server, thread) -> None:
    server.shutdown()
    server.server_close()
    thread.join(30)
    if thread.is_alive():
        fail("a server's thread did not stop")


def _http_rounds(conns, sids, rounds: int, n: int) -> float:
    """``rounds`` POST steps of ``n`` generations from one thread a session,
    each on its own keep-alive connection, all started together; the wall
    seconds."""
    errors, barrier = [], threading.Barrier(len(sids))

    def run(conn, sid):
        try:
            barrier.wait()
            for _ in range(rounds):
                status, _, raw = _http(conn, "POST", f"/sessions/{sid}/step",
                                       {"steps": n})
                if status != 200:
                    errors.append((status, raw[:200]))
                    return
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=cs)
               for cs in zip(conns, sids)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(FRONT_WAIT_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        fail(f"serving over HTTP failed: {errors[:3]}")
    return wall


def _frame_cells(raw: bytes, generation: int, shape) -> torch.Tensor:
    """A binary frame's grid on the card, checked for its generation and
    shape."""
    grid, meta = wire.decode_frame(raw)
    if meta["generation"] != generation or grid.shape != tuple(shape):
        fail(f"a frame holds generation {meta['generation']} of "
             f"{grid.shape}, not {generation} of {tuple(shape)}")
    return torch.from_numpy(np.ascontiguousarray(grid)).to("cuda")


def _scrape_families(text: str) -> set:
    return {ln.split()[2] for ln in text.splitlines()
            if ln.startswith("# TYPE ")}


def _front_profile(conns, sids, n: int, address) -> dict:
    """``POST /debug/profile?secs=2`` under the same HTTP traffic: the K1
    launches counted inside the capture against the K1 records of the
    Chrome trace the endpoint wrote (phase 7's trace rule, lead and first
    launch)."""
    def attempt():
        out = {}

        def post():
            conn = _connect(address)
            try:
                out["reply"] = _http(conn, "POST",
                                     f"/debug/profile?secs={FRONT_PROFILE_S}")
            finally:
                conn.close()

        t = threading.Thread(target=post)
        t.start()
        if not capturing.wait(60):
            fail("the profile endpoint's capture did not start")
        # the profiler's first kernel
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        time.sleep(OBS_LEAD_S)
        _reset_launches()
        t0, rounds = time.perf_counter(), 0
        while time.perf_counter() - t0 < OBS_TRAFFIC_S:
            _http_rounds(conns, sids, 1, n)
            rounds += 1
        torch.cuda.synchronize()
        counted = _launches()
        if not capturing.is_set():
            fail("the profiled traffic outlasted the capture")
        t.join(120)
        status, _, raw = out.get("reply", (None, None, b""))
        doc = json.loads(raw) if status == 200 else {}
        if t.is_alive() or not doc.get("ok"):
            fail(f"POST /debug/profile failed: {status} {raw[:300]!r}")
        with open(doc["path"]) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        in_trace = {kid: sum(1 for e in kernels
                             if any(nm in e.get("name", "") for nm in names))
                    for kid, names in KERNEL_NAMES.items()}
        if counted["K2"] or counted["K3"] or not counted["K1"]:
            fail(f"the profiled HTTP traffic launched {counted}")
        return ({"K1": counted["K1"]}, {"K1": in_trace["K1"]},
                {"rounds": rounds, "k1_launches": counted["K1"],
                 "trace_kernels": in_trace, "trace_events": len(events),
                 "capture_s": doc["seconds"], "lead_s": OBS_LEAD_S,
                 "kernel_placement": _kernel_placement(events, kernels)})

    result, takes, lost = _trace_holds_launches("profile endpoint", attempt)
    return {**result, "takes": takes, "records_lost_on_retaken": lost}


def _front_admission(card: str, mgr, obs, engine, address, size: int,
                     n: int) -> None:
    """Admission on the card: a tenant whose window is below one request's
    estimate (K1's card over the card's roof) gets 429 with Retry-After and
    no launch; a roomy tenant is served."""
    roof = roof_ops_per_s()
    cells = size * size
    per_cell = ops_per_cell_estimate(engine.cost_cards(), cells)
    if roof is None or per_cell != word_ops(LIFE) / WORD:
        fail(f"no estimate from K1's card ({per_cell} instructions a cell) "
             f"and the card's roof ({roof})")
    est_s = per_cell * cells * n / roof
    adm = AdmissionControl(normalize_tenants([
        {"name": "tight", "device_s_per_window": est_s / 2},
        {"name": "roomy", "device_s_per_window": est_s * 1e4}]))
    adm.arm(mgr, obs)
    spec = {"rows": size, "cols": size, "rule": "life",
            "comm_every": FRONT_LIFE[2], "segments": [1, FRONT_LIFE[2]],
            "seed": SEED}
    conn = _connect(address)
    try:
        out = {}
        for tenant, want in (("tight", 429), ("roomy", 200)):
            head = {"X-Gol-Tenant": tenant}
            sid = _http_json(conn, "POST", "/sessions", spec, head)["id"]
            session = mgr.get(sid)
            if adm.estimate(session, n) != (est_s, n * cells):
                fail(f"the {tenant} request's estimate "
                     f"{adm.estimate(session, n)} is not K1's card's "
                     f"{est_s} s")
            _reset_launches()
            t0 = time.perf_counter()
            status, headers, raw = _http(conn, "POST",
                                         f"/sessions/{sid}/step",
                                         {"steps": n}, head)
            http_ms = (time.perf_counter() - t0) * 1e3
            launches = _launches()
            if status != want:
                fail(f"the {tenant} tenant's step answered {status}, not "
                     f"{want}: {raw[:300]!r}")
            if want == 429:
                if (not headers.get("Retry-After")
                        or launches != {"K1": 0, "K2": 0, "K3": 0}):
                    fail(f"the refused step had Retry-After "
                         f"{headers.get('Retry-After')} and launched "
                         f"{launches}")
                out[tenant] = {"status": status,
                               "retry_after": headers["Retry-After"],
                               "launches": launches,
                               "error": json.loads(raw)["error"]}
            else:
                if launches["K1"] < 1 or launches["K2"] or launches["K3"]:
                    fail(f"the admitted step launched {launches}")
                row = obs.ledger.session_row(sid)
                out[tenant] = {"status": status, "launches": launches,
                               "http_ms": http_ms,
                               "step_device_ms": row["device_s"] * 1e3}
    finally:
        conn.close()
    emit({"phase": "front", "part": "admission", "card": card,
          "grid": [size, size], "generations_a_request": n,
          "estimate_s": est_s, "estimate_instructions": per_cell * cells * n,
          "roof_ops_per_s": roof, "tight_window_s": est_s / 2,
          "tenants": out, "decisions": adm.tenants_block()})


def _front_threaded(card: str, times: dict) -> None:
    """The threaded front in process: 32 keep-alive clients on 4096² Life,
    every board read back as a binary frame, the endpoints, the profile
    capture and admission."""
    B, size, k, n, rounds = FRONT_LIFE
    obs = Obs()
    mgr = SessionManager(EngineCache(), batch_max=B, obs=obs)
    obs.arm_telemetry(manager=mgr, start=False)
    obs.arm_flight(manager=mgr, anomaly=True)
    logdir = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    server = make_server(port=0, manager=mgr, profile_dir=logdir)
    thread = _serving(server)
    conns = [_connect(server.server_address) for _ in range(B)]
    try:
        spec = {"rows": size, "cols": size, "rule": "life", "comm_every": k,
                "segments": [1, k]}
        infos = [_http_json(c, "POST", "/sessions", dict(spec, seed=SEED + b))
                 for b, c in enumerate(conns)]
        if [i["cache_hit"] for i in infos] != [False] + [True] * (B - 1):
            fail("the HTTP Life sessions' creates were not one miss and hits")
        sids = [i["id"] for i in infos]
        engine = mgr.get(sids[0]).engine
        if engine.kernel_id != "K1" or engine.device.type != "cuda":
            fail(f"the HTTP Life sessions run on {engine.kernel_id} on "
                 f"{engine.device}")
        _http_rounds(conns, sids, 1, n)     # warms the (n, B) batched step
        builds = _build.builds
        st0, c0 = mgr.batcher.stats(), engine.compile_count
        _reset_launches()
        cpu0 = time.process_time()
        wall = _http_rounds(conns, sids, rounds, n)
        cpu = time.process_time() - cpu0
        launches = _launches()
        st1 = mgr.batcher.stats()
        calls = (st1["coalesced_calls"] - st0["coalesced_calls"]
                 + st1["solo_steps"] - st0["solo_steps"])
        warmups = engine.compile_count - c0
        if launches != {"K1": calls + warmups, "K2": 0, "K3": 0} \
                or not calls:
            fail(f"HTTP serving launched {launches} for {calls} steps and "
                 f"{warmups} warm-ups (one K1 launch each)")
        if _build.builds != builds:
            fail("a kernel was built while HTTP served")
        _no_faults(mgr, "HTTP Life")
        total = n * (1 + rounds)
        # every board back as a binary frame, equal to step_batched's and
        # (the first and last) to the plain version's
        ref = engine.step_batched(
            engine.init_grids(seeds=[SEED + b for b in range(B)]), total)
        plain = torch.stack([init_packed(size, size, SEED + b, device="cuda")
                             for b in (0, B - 1)])
        for _ in range(total):
            plain = bit_step_plain(plain, LIFE, "periodic", 1)
        frame_bytes = 0
        for b, (c, sid) in enumerate(zip(conns, sids)):
            status, headers, raw = _http(
                c, "GET", f"/sessions/{sid}/snapshot",
                headers={"Accept": wire.GRID_MEDIA_TYPE})
            if status != 200 or headers.get("Content-Type") \
                    != wire.GRID_MEDIA_TYPE:
                fail(f"the binary snapshot of {sid} answered {status}")
            frame_bytes += len(raw)
            got = _frame_cells(raw, total, (size, size))
            if not torch.equal(got, unpack(ref[b])):
                fail(f"the HTTP frame of {sid} differs from step_batched's")
            if b in (0, B - 1) and not torch.equal(
                    got, unpack(plain[0 if b == 0 else 1])):
                fail(f"the HTTP frame of {sid} differs from the plain "
                     f"version's")
        del ref, plain
        rps = B * rounds / wall
        phase6_rps = times["serve", "requests_per_s"]
        emit({"phase": "front", "part": "threaded_life", "card": card,
              "kernel": "K1", "sessions": B, "grid": [size, size],
              "comm_every": k, "generations_a_request": n, "rounds": rounds,
              "launches": launches, "steps": calls, "warmups": warmups,
              "avg_occupancy": (st1["batched_boards"]
                                - st0["batched_boards"]) / max(1, calls),
              "serving_wall_s": wall, "requests_per_s": rps,
              "host_cpu_ms_per_request": cpu * 1e3 / (B * rounds),
              "phase6_in_process_requests_per_s": phase6_rps,
              "http_over_in_process": rps / phase6_rps,
              "frames_equal_to_step_batched_and_plain": B,
              "frame_bytes": frame_bytes, "builds_while_serving": 0})
        # the endpoints: the reference's families, /usage as the manager
        # reads it, and the profile capture under the same traffic
        status, headers, raw = _http(conns[0], "GET", "/metrics")
        names = _scrape_families(raw.decode())
        want = (set(FAMILIES["core"]) | set(FAMILIES["slo"])
                | set(FAMILIES["flight"]))
        if status != 200 or not want <= names:
            fail(f"/metrics answered {status} without "
                 f"{sorted(want - names)}")
        usage = _http_json(conns[0], "GET", "/usage")
        if usage != json.loads(json.dumps(mgr.usage())):
            fail("GET /usage differs from the manager's usage()")
        prof = _front_profile(conns, sids, n, server.server_address)
        emit({"phase": "front", "part": "endpoints", "card": card,
              "metric_families": len(names), "reference_families":
                  len(want), "usage_equal": True,
              "usage_totals": usage["totals"], "profile": prof})
        _front_admission(card, mgr, obs, engine, server.server_address,
                         size, n)
        _no_faults(mgr, "HTTP")
    finally:
        for c in conns:
            c.close()
        _stop_serving(server, thread)
        mgr.shutdown()
        obs.close()
        shutil.rmtree(logdir, ignore_errors=True)
    torch.cuda.empty_cache()


def _read_chunks(sock, buf: bytearray, frames: list, want: int) -> None:
    """Read a chunked stream until ``frames`` holds ``want`` frames: every
    chunk the aio front writes holds one whole frame."""
    deadline = time.monotonic() + FRONT_WAIT_S
    while len(frames) < want:
        i = buf.find(b"\r\n")
        if i >= 0 and len(buf) >= i + 2 + int(buf[:i], 16) + 2:
            size = int(buf[:i], 16)
            got, rest = wire.split_frames(bytes(buf[i + 2:i + 2 + size]))
            if rest or len(got) != 1:
                fail(f"a stream chunk held {len(got)} frames and "
                     f"{len(rest)} bytes more")
            frames.extend(got)
            del buf[:i + 2 + size + 2]
            continue
        if time.monotonic() > deadline:
            fail(f"the stream pushed {len(frames)} of {want} frames")
        data = sock.recv(1 << 20)
        if not data:
            fail("the stream closed")
        buf += data


def _front_aio(card: str) -> None:
    """The aio front: Bosco on K3 and K2 through tickets read by parked
    waiters, then one stream of a frame a generation."""
    per, size, depths, cycles = FRONT_LTL
    mgr = SessionManager(EngineCache())
    server = make_aio_server(port=0, manager=mgr)
    thread = _serving(server)
    conn = _connect(server.server_address)
    conns = []
    try:
        sids = {kid: [_http_json(conn, "POST", "/sessions",
                                 {"rows": size, "cols": size,
                                  "rule": "bosco", "comm_every": ce,
                                  "seed": SEED + i})["id"]
                      for i in range(per)]
                for kid, ce in (("K3", 1), ("K2", 3))}
        for kid, ids in sids.items():
            eng = mgr.get(ids[0]).engine
            if eng.kernel_id != kid or eng.device.type != "cuda":
                fail(f"the aio Bosco sessions meant for {kid} run on "
                     f"{eng.kernel_id} on {eng.device}")
        every = sids["K3"] + sids["K2"]
        conns = [_connect(server.server_address) for _ in every]

        def cycle():
            errors = []

            def run(c, i, sid):
                try:
                    tickets = []
                    for d in depths[i % len(depths):] \
                            + depths[:i % len(depths)]:
                        status, _, raw = _http(
                            c, "POST", f"/sessions/{sid}/step?async=1",
                            {"steps": d})
                        if status != 200:
                            errors.append((status, raw[:200]))
                            return
                        tickets.append(json.loads(raw)["ticket"])
                    for t in tickets:
                        status, _, raw = _http(c, "GET",
                                               f"/result/{t}?wait=1")
                        if status != 200 or \
                                json.loads(raw)["status"] != "done":
                            errors.append((status, raw[:200]))
                except Exception as e:  # noqa: BLE001 — reported below
                    errors.append(e)

            threads = [threading.Thread(target=run, args=(c, i, s))
                       for i, (c, s) in enumerate(zip(conns, every))]
            for t in threads:
                t.start()
            for t in threads:
                t.join(FRONT_WAIT_S)
            if errors or any(t.is_alive() for t in threads):
                fail(f"the aio ticket cycle failed: {errors[:3]}")

        cycle()                         # warms the batch widths a cycle meets
        engines = [mgr.get(ids[0]).engine for ids in sids.values()]
        builds = _build.builds
        st0, a0 = mgr.dispatcher.stats(), server.stats()
        c0 = sum(e.compile_count for e in engines)
        _reset_launches()
        t0 = time.perf_counter()
        for _ in range(cycles):
            cycle()
        wall = time.perf_counter() - t0
        launches = _launches()
        st1, a1 = mgr.dispatcher.stats(), server.stats()
        unit_rounds = st1["unit_rounds"] - st0["unit_rounds"]
        warmups = sum(e.compile_count for e in engines) - c0
        waits = cycles * len(every) * len(depths)
        if (launches["K1"] or not launches["K3"] or not launches["K2"]
                or launches["K3"] + launches["K2"] != unit_rounds + warmups
                or st1["solo_tickets"] != st0["solo_tickets"]):
            fail(f"the aio ticket rounds launched {launches} for "
                 f"{unit_rounds} unit rounds and {warmups} warm-ups")
        if a1["parked_total"] - a0["parked_total"] != waits:
            fail(f"{a1['parked_total'] - a0['parked_total']} of {waits} "
                 f"ticket reads parked")
        if _build.builds != builds:
            fail("a kernel was built while the aio front served")
        _no_faults(mgr, "aio ticket")
        gens = (1 + cycles) * sum(depths)
        plain = {kid: _ltl_plain(kid, size, [SEED + i for i in range(per)],
                                 gens) for kid in sids}
        for kid, ids in sids.items():
            for i, sid in enumerate(ids):
                status, _, raw = _http(
                    conn, "GET", f"/sessions/{sid}/snapshot",
                    headers={"Accept": wire.GRID_MEDIA_TYPE})
                got = _frame_cells(raw, gens, (size, size))
                want = (unpack(plain[kid][i]) if kid == "K3"
                        else plain[kid][i])
                if status != 200 or not torch.equal(got, want):
                    fail(f"the aio {kid} session {sid} differs from the "
                         f"plain version's")
        emit({"phase": "front", "part": "aio_tickets", "card": card,
              "sessions": {kid: per for kid in sids}, "grid": [size, size],
              "rule": "bosco", "comm_every": {"K3": 1, "K2": 3},
              "depths": list(depths), "cycles": cycles, "generations": gens,
              "launches": launches, "unit_rounds": unit_rounds,
              "warmups": warmups, "parked_waits": waits, "wall_s": wall,
              "board_generations_per_s":
                  len(every) * cycles * sum(depths) / wall,
              "boards_equal_to_plain": True, "aio": server.stats()})
        # one stream, a frame a generation: each frame the plain board
        sid = sids["K3"][0]
        board = plain["K3"][0:1]
        del plain
        sock = socket.create_connection(server.server_address[:2],
                                        timeout=FRONT_WAIT_S)
        try:
            sock.sendall(f"GET /stream/{sid}?every=1 HTTP/1.1\r\n"
                         f"Host: chip\r\n\r\n".encode())
            buf = bytearray()
            while b"\r\n\r\n" not in buf:
                data = sock.recv(65536)
                if not data:
                    fail("the stream closed before its head")
                buf += data
            head, _, rest = bytes(buf).partition(b"\r\n\r\n")
            if b"200" not in head.split(b"\r\n")[0] \
                    or b"chunked" not in head:
                fail(f"the stream answered {head[:200]!r}")
            buf = bytearray(rest)
            frames = []
            _read_chunks(sock, buf, frames, 1)
            _reset_launches()
            for g in range(1, FRONT_FRAMES + 1):
                _http_json(conn, "POST", f"/sessions/{sid}/step",
                           {"steps": 1})
                _read_chunks(sock, buf, frames, g + 1)
            stream_launches = _launches()
            for i, (grid, meta) in enumerate(frames):
                if i:
                    board = ltl_step_plain(board, BOSCO, "periodic", 1)
                if meta["generation"] != gens + i or not torch.equal(
                        torch.from_numpy(np.ascontiguousarray(grid))
                        .to("cuda"), unpack(board[0])):
                    fail(f"stream frame {i} (generation "
                         f"{meta['generation']}) differs from the plain "
                         f"board at {gens + i}")
        finally:
            sock.close()
        if stream_launches["K3"] < FRONT_FRAMES or stream_launches["K1"] \
                or stream_launches["K2"]:
            fail(f"the streamed steps launched {stream_launches}")
        emit({"phase": "front", "part": "aio_stream", "card": card,
              "session": sid, "kernel": "K3", "frames": len(frames),
              "generations": [m["generation"] for _, m in frames],
              "launches": stream_launches, "frames_equal_to_plain": True,
              "frames_pushed": server.stats()["frames_pushed"]})
    finally:
        for c in conns + [conn]:
            c.close()
        _stop_serving(server, thread)
        mgr.shutdown()
    torch.cuda.empty_cache()


def _await_line(proc, lines, limit_s: float) -> str:
    """The server process's startup line, read by ``lines``' reader thread
    within ``limit_s``."""
    try:
        while True:
            line = lines.get(timeout=limit_s)
            if line is None:
                fail(f"the server process exited ({proc.poll()}) before "
                     f"it served")
            if "serving on http://" in line:
                return line
    except queue.Empty:
        fail(f"the server process did not serve within {limit_s} s")


def _server_process(args, err):
    """A server process on the card (its stderr to the file ``err``), and
    a queue of its stdout lines."""
    proc = subprocess.Popen(args, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=err, text=True)
    lines = queue.Queue()

    def read():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=read, daemon=True).start()
    return proc, lines


def _front_restart(card: str) -> None:
    """``python -m mpi_tpu_torch.cli serve`` on the card with a state dir:
    a 4096² Bosco session on K3 stepped k times, the server SIGKILLed, a
    second server restoring generation k and stepping on to the plain
    board at k + m."""
    size, k, m = FRONT_RESTART
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    state = os.path.join(work, "state")
    args = [sys.executable, "-m", "mpi_tpu_torch.cli", "serve", "--port",
            "0", "--state-dir", state, "--checkpoint-every", "1"]
    spec = {"rows": size, "cols": size, "rule": "bosco", "comm_every": 1,
            "seed": SEED}
    walls = {}
    try:
        for run in ("first", "restored"):
            t0 = time.perf_counter()
            err = open(os.path.join(work, f"{run}.err"), "w+")
            proc, lines = _server_process(args, err)
            try:
                line = _await_line(proc, lines, FRONT_WAIT_S)
                walls[f"{run}_start_s"] = time.perf_counter() - t0
                host, port = line.split("http://", 1)[1].split(" ", 1)[0] \
                    .rsplit(":", 1)
                conn = http.client.HTTPConnection(host, int(port),
                                                  timeout=FRONT_WAIT_S)
                try:
                    if run == "first":
                        sid = _http_json(conn, "POST", "/sessions",
                                         spec)["id"]
                        for _ in range(k):
                            _http_json(conn, "POST",
                                       f"/sessions/{sid}/step", {"steps": 1})
                        continue
                    health = _http_json(conn, "GET", "/healthz")
                    gen = _http_json(conn, "GET",
                                     f"/sessions/{sid}/density")["generation"]
                    if health["restored_sessions"] != 1 or gen != k \
                            or "restored 1" not in line:
                        fail(f"the restarted server restored "
                             f"{health['restored_sessions']} sessions at "
                             f"generation {gen}, not 1 at {k}")
                    for _ in range(m):
                        _http_json(conn, "POST", f"/sessions/{sid}/step",
                                   {"steps": 1})
                    status, _, raw = _http(
                        conn, "GET", f"/sessions/{sid}/snapshot",
                        headers={"Accept": wire.GRID_MEDIA_TYPE})
                finally:
                    conn.close()
            finally:
                proc.kill()             # SIGKILL: no shutdown, no flush
                proc.wait(60)
                proc.stdout.close()
                err.seek(0)
                errors = err.read()
                err.close()
        board = _ltl_plain("K3", size, [SEED], k + m)[0]
        if status != 200 or not torch.equal(
                _frame_cells(raw, k + m, (size, size)), unpack(board)):
            fail(f"the restored session's board at {k + m} differs from "
                 f"the plain version's: {errors[-500:]}")
        emit({"phase": "front", "part": "restart", "card": card,
              "grid": [size, size], "kernel": "K3", "rule": "bosco",
              "steps_before_kill": k, "steps_after_restore": m,
              "restored_generation": k, "board_equal_to_plain": True,
              **walls})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase8_front(card: str, times: dict) -> None:
    """The network front on the card (``serve/httpd.py``, ``serve/aio.py``,
    ``serve/cli.py``, ``admission/``)."""
    _front_threaded(card, times)
    _front_aio(card)
    _front_restart(card)


# phase 9: three `python -m mpi_tpu_torch.cli serve --device cuda`
# processes on loopback ports as one cluster over one shared state dir,
# with the chaos settings of the reference's tools/cluster_smoke.py
CLUSTER_NODES = 3
CLUSTER_ARGS = ("--device", "cuda", "--checkpoint-every", "1",
                "--gossip-interval-s", "0.25", "--peer-down-s", "1.0",
                "--peer-dead-s", "2.5", "--telemetry-interval-s", "0.25",
                "--flight-recorder")
# (sessions, size, generations a request, rounds a turn): 4096² Life on
# K1 (comm_every 8), stepped in turns proxied, direct, direct, proxied
CLUSTER_LIFE = (24, 4096, 8, 4)
CLUSTER_LTL = 4         # 4096² Bosco sessions on K3 (comm_every 1), on K2 (3)
CLUSTER_WAIT_S = 60.0   # the limit of every wait for the group
# each node runs `python -m mpi_tpu_torch.cli serve ...` as __main__ and,
# as it exits, prints its wrappers' launch counts (a SIGKILLed node prints
# none): the counts start at 0 with the process, before any traffic
CLUSTER_NODE_MAIN = (
    "import atexit, json, runpy, sys\n"
    "from mpi_tpu_torch.backends import cuda\n"
    "from mpi_tpu_torch.parallel import seam\n"
    "atexit.register(lambda: print(json.dumps({'launches': {**{kid: "
    "w.launches for kid, w, _ in cuda.KERNELS.values()}, 'seam': "
    "seam.fused_band.launches}}), flush=True))\n"
    "sys.argv = ['mpi_tpu_torch.cli', *sys.argv[1:]]\n"
    "runpy.run_module('mpi_tpu_torch.cli', run_name='__main__',"
    " alter_sys=True)\n"
)


def _free_ports(n: int) -> list:
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _cpu_s(pid: int) -> float:
    """A process's user + system CPU seconds (``/proc/<pid>/stat``)."""
    with open(f"/proc/{pid}/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def _req(addr: str, method: str, path: str, body=None, headers=None):
    """One request on a connection of its own: (status, headers, bytes)."""
    host, port = addr.rsplit(":", 1)
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=CLUSTER_WAIT_S)
    try:
        return _http(conn, method, path, body, headers)
    finally:
        conn.close()


def _req_json(addr: str, method: str, path: str, body=None, headers=None,
              want: int = 200):
    status, _, raw = _req(addr, method, path, body, headers)
    if status != want:
        fail(f"{method} {addr}{path} answered {status}, not {want}: "
             f"{raw[:300]!r}")
    return json.loads(raw) if raw else None


def _poll(fn, label: str, limit_s: float = CLUSTER_WAIT_S):
    """``fn()`` until it returns a true value, within ``limit_s``: that
    value and the seconds it took."""
    t0 = time.perf_counter()
    while True:
        out = fn()
        if out:
            return out, time.perf_counter() - t0
        if time.perf_counter() - t0 > limit_s:
            fail(f"the cluster never {label} within {limit_s} s")
        time.sleep(0.05)


def _frame(addr: str, sid: str):
    """(status, headers, bytes) of a binary snapshot through ``addr``."""
    return _req(addr, "GET", f"/sessions/{sid}/snapshot",
                headers={"Accept": wire.GRID_MEDIA_TYPE})


def _holders(addrs, sids) -> dict:
    """sid -> the node that holds it: a forwarded request is served where
    it lands, so exactly one node answers 200."""
    from mpi_tpu_torch.cluster.proxy import FORWARDED_HEADER

    out = {}
    for sid in sids:
        held = [a for a in addrs
                if _req(a, "GET", f"/sessions/{sid}/density",
                        headers={FORWARDED_HEADER: "probe"})[0] == 200]
        if len(held) != 1:
            fail(f"session {sid} is held by {held}, not by one node")
        out[sid] = held[0]
    return out


class _Plain:
    """Each session's plain board (K1's, K3's or K2's plain version on
    the card), advanced as the session's generation moves."""

    def __init__(self, kinds: dict, seeds: dict):
        size = CLUSTER_LIFE[1]
        self.kinds, self.state, self.gen = kinds, {}, {}
        for sid, kid in kinds.items():
            self.gen[sid] = 0
            self.state[sid] = (
                init_dense(size, size, seeds[sid], device="cuda")
                if kid == "K2" else
                init_packed(size, size, seeds[sid], device="cuda"))[None]

    def cells(self, sid: str, gen: int) -> torch.Tensor:
        kid, x, n = self.kinds[sid], self.state[sid], gen - self.gen[sid]
        if n < 0:
            fail(f"session {sid} went back to generation {gen}")
        cap = {"K1": 16, "K3": 1, "K2": 3}[kid]
        while n:
            g = min(n, cap)
            x = (bit_step_plain(x, LIFE, "periodic", g) if kid == "K1"
                 else ltl_step_plain(x, BOSCO, "periodic", g) if kid == "K3"
                 else dense_step_plain(x, BOSCO, "periodic", g))
            n -= g
        self.state[sid], self.gen[sid] = x, gen
        return x[0] if kid == "K2" else unpack(x[0])


def _cluster_boards(addrs, holder, gens, plain, label) -> None:
    """Every session's board through a front that does not hold it and
    through its holder: byte for byte the same binary frame, equal to the
    plain version's board."""
    size = CLUSTER_LIFE[1]
    for sid, owner in holder.items():
        other = addrs[(addrs.index(owner) + 1) % len(addrs)]
        st1, _, far = _frame(other, sid)
        st2, _, near = _frame(owner, sid)
        if st1 != 200 or st2 != 200 or far != near:
            fail(f"{label}: the frame of {sid} through {other} ({st1}) and "
                 f"its holder {owner} ({st2}) differ")
        if not torch.equal(_frame_cells(far, gens[sid], (size, size)),
                           plain.cells(sid, gens[sid])):
            fail(f"{label}: the board of {sid} at {gens[sid]} differs from "
                 f"the plain version's")


def _cluster_turn(fronts: dict, sids, rounds: int, n: int, pids) -> tuple:
    """``rounds`` steps of ``n`` generations a session, each session's
    client on one keep-alive connection to ``fronts[sid]``: (wall s, the
    nodes' CPU s).  The connections open one at a time before the
    rounds: a node's listen queue holds 5 (``ThreadingHTTPServer``'s
    default, as in the reference), and 32 clients connecting at once to
    one node can be reset."""
    conns = []
    for sid in sids:
        host, port = fronts[sid].rsplit(":", 1)
        conns.append(http.client.HTTPConnection(host, int(port),
                                                timeout=FRONT_WAIT_S))
        conns[-1].connect()
    try:
        cpu0 = sum(_cpu_s(p) for p in pids)
        wall = _http_rounds(conns, list(sids), rounds, n)
        return wall, sum(_cpu_s(p) for p in pids) - cpu0
    finally:
        for c in conns:
            c.close()


def _cluster_start(work: str, nodes: list) -> None:
    """Three nodes started together over one state dir, appended to
    ``nodes`` as they start (so the caller stops each one whatever
    fails): each one's address, process, stdout lines, stderr file and
    seconds to serve."""
    addrs = [f"127.0.0.1:{p}" for p in _free_ports(CLUSTER_NODES)]
    state = os.path.join(work, "state")
    t0 = time.perf_counter()
    for i, addr in enumerate(addrs):
        peers = ",".join(a for a in addrs if a != addr)
        args = [sys.executable, "-c", CLUSTER_NODE_MAIN, "serve", "--host",
                "127.0.0.1", "--port", addr.rsplit(":", 1)[1],
                "--state-dir", state, "--peers", peers, *CLUSTER_ARGS]
        err = open(os.path.join(work, f"node{i}.err"), "w+")
        proc, lines = _server_process(args, err)
        nodes.append({"addr": addr, "proc": proc, "lines": lines,
                      "err": err})
    from mpi_tpu_torch.cluster import node_tag

    for node in nodes:
        line = _await_line(node["proc"], node["lines"], FRONT_WAIT_S)
        node["start_s"] = time.perf_counter() - t0
        want = f"cluster {node['addr']} tag {node_tag(node['addr'])} peers 2"
        if want not in line:
            fail(f"a node's startup line lacks {want!r}: {line!r}")


def _cluster_stop(node) -> dict:
    """SIGINT: the node shuts down and prints its launch counts."""
    proc = node["proc"]
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(60)
    except subprocess.TimeoutExpired:
        fail(f"the node {node['addr']} did not stop on SIGINT")
    launches = None
    while True:
        try:
            line = node["lines"].get(timeout=10)
        except queue.Empty:
            break
        if line is None:
            break
        if line.startswith('{"launches"'):
            launches = json.loads(line)["launches"]
    if proc.returncode != 0 or launches is None:
        node["err"].seek(0)
        fail(f"the node {node['addr']} exited {proc.returncode} without "
             f"its launch counts: {node['err'].read()[-800:]}")
    return launches


def phase9_cluster(card: str) -> None:
    """Cluster mode on the card: sticky routing and the proxy, the
    stitched trace, the roll-ups, a SIGKILL failover, a drain and the
    offline scrub (``mpi_tpu_torch/cluster``, ``serve/transport.py``'s
    routing, ``serve/cli.py``'s ``--peers``)."""
    from mpi_tpu_torch.obs.ledger import merge_totals

    n_life, size, n, rounds = CLUSTER_LIFE
    work = tempfile.mkdtemp(dir=os.path.join(ROOT, "build"))
    state = os.path.join(work, "state")
    nodes = []
    try:
        t_phase = time.perf_counter()
        _cluster_start(work, nodes)
        addrs = [nd["addr"] for nd in nodes]
        pids = [nd["proc"].pid for nd in nodes]

        def joined():
            for a in addrs:
                peers = _req_json(a, "GET", "/cluster")["peers"]
                if sorted(peers) != sorted(set(addrs) - {a}) or not all(
                        p["alive"] for p in peers.values()):
                    return False
            return True

        _, join_s = _poll(joined, "joined")
        # the sessions, created through the three fronts in turn
        kinds, seeds, specs = {}, {}, []
        for i in range(n_life):
            specs.append(("K1", SEED + i, {"rule": "life", "comm_every": 8}))
        for kid, k in (("K3", 1), ("K2", 3)):
            for i in range(CLUSTER_LTL):
                specs.append((kid, SEED + i, {"rule": "bosco",
                                              "comm_every": k}))
        t0 = time.perf_counter()
        for j, (kid, seed, extra) in enumerate(specs):
            out = _req_json(addrs[j % CLUSTER_NODES], "POST", "/sessions",
                            {"rows": size, "cols": size, "seed": seed,
                             **extra})
            kinds[out["id"]], seeds[out["id"]] = kid, seed
        create_s = time.perf_counter() - t0
        sids = list(kinds)
        holder = _holders(addrs, sids)
        plain = _Plain(kinds, seeds)
        gens = {sid: 0 for sid in sids}
        # 1. sticky routing and the proxy: turns through a front that does
        # not hold the session and through its holder
        proxied = {sid: addrs[(addrs.index(h) + 1) % CLUSTER_NODES]
                   for sid, h in holder.items()}
        turns = {"proxied": [], "direct": []}
        for turn in ("proxied", "direct", "direct", "proxied"):
            fronts = proxied if turn == "proxied" else holder
            turns[turn].append(_cluster_turn(fronts, sids, rounds, n, pids))
            for sid in sids:
                gens[sid] += rounds * n
        _cluster_boards(addrs, holder, gens, plain, "routing")
        reqs = len(sids) * rounds
        rate = {t: reqs * len(v) / sum(w for w, _ in v)
                for t, v in turns.items()}
        cpu_ms = {t: 1e3 * sum(c for _, c in v) / (reqs * len(v))
                  for t, v in turns.items()}
        flights = {}
        for sid in sids:
            recs = _req_json(holder[sid], "GET",
                             f"/debug/flights?session={sid}")["flights"]
            got = {r.get("kernel") for r in recs}
            if got != {kinds[sid]}:
                fail(f"session {sid} stepped on {got}, not {kinds[sid]}")
            flights[kinds[sid]] = flights.get(kinds[sid], 0) + len(recs)
        emit({"phase": "cluster", "part": "routing", "card": card,
              "nodes": CLUSTER_NODES, "node_start_s":
                  [nd["start_s"] for nd in nodes], "join_s": join_s,
              "sessions": {k: sum(v == k for v in kinds.values())
                           for k in ("K1", "K3", "K2")},
              "held": {a: sum(h == a for h in holder.values())
                       for a in addrs},
              "grid": [size, size], "generations_a_request": n,
              "requests_a_turn": reqs, "create_s": create_s,
              "proxied_requests_per_s": rate["proxied"],
              "direct_requests_per_s": rate["direct"],
              "proxied_over_direct": rate["proxied"] / rate["direct"],
              "node_cpu_ms_per_request": cpu_ms,
              "host_cpu_ms_a_hop": cpu_ms["proxied"] - cpu_ms["direct"],
              "turn_walls_s": {t: [w for w, _ in v]
                               for t, v in turns.items()},
              "flight_records_by_kernel": flights,
              "frames_equal_to_holder_and_plain": len(sids)})
        # 2. the stitched trace: a proxied async step, fetched from the
        # third front
        sid = sids[0]
        owner = holder[sid]
        f1 = proxied[sid]
        f3 = next(a for a in addrs if a not in (owner, f1))
        status, headers, raw = _req(f1, "POST",
                                    f"/sessions/{sid}/step?async=1",
                                    {"steps": n})
        tp = headers.get("X-Gol-Traceparent", "")
        if status != 200 or len(tp.split("-")) != 4:
            fail(f"the proxied async step answered {status}, {tp!r}")
        ticket = json.loads(raw)["ticket"]
        res = _req_json(f1, "GET", f"/result/{ticket}?wait=1")
        if res["status"] != "done":
            fail(f"the proxied ticket {ticket} did not finish: {res}")
        gens[sid] += n
        tid = tp.split("-")[1]
        doc = _req_json(f3, "GET", f"/debug/trace/{tid}")

        def tree_nodes(node, acc):
            acc.add(node["node"])
            for c in node["children"]:
                tree_nodes(c, acc)
            return acc

        names = {s["name"] for s in doc["spans"]}
        span_nodes = {s["node"] for s in doc["spans"]}
        if not doc["complete"] or span_nodes != {f1, owner} or not any(
                len(tree_nodes(r, set())) == 2 for r in doc["tree"]) \
                or not {"http_request", "proxy_hop"} <= names:
            fail(f"the trace fetched from {f3} is not one tree of {f1} and "
                 f"{owner}: {sorted(names)}, {sorted(span_nodes)}")
        emit({"phase": "cluster", "part": "trace", "card": card,
              "fetched_from": f3, "front": f1, "owner": owner,
              "ticket": ticket, "spans": len(doc["spans"]),
              "span_names": sorted(names), "nodes": doc["nodes"],
              "complete": True})
        # 3. the roll-ups: /usage totals, /slo, /metrics, polled from the
        # last request on
        def usage_converged():
            usages = {a: _req_json(a, "GET", "/usage") for a in addrs}
            local = {a: u["totals"] for a, u in usages.items()}
            for a, u in usages.items():
                cl = u["cluster"]
                if cl["nodes_reporting"] != CLUSTER_NODES \
                        or cl["by_node"] != local \
                        or cl["totals"] != merge_totals(
                            list(cl["by_node"].values())):
                    return None
            return local

        local, usage_s = _poll(usage_converged, "converged on /usage")

        def slo_named():
            for a in addrs:
                cl = _req_json(a, "GET", "/slo")["cluster"]
                if sorted(cl["by_node"]) != sorted(addrs) \
                        or cl["nodes_reporting"] != CLUSTER_NODES:
                    return False
            return True

        _, slo_s = _poll(slo_named, "named every node on /slo")
        for a in addrs:
            status, _, raw = _req(a, "GET", "/metrics")
            text = raw.decode()
            missing = set(FAMILIES["cluster"]) - _scrape_families(text)
            if status != 200 or missing or f'process="{a}"' not in text \
                    or 'host="' not in text:
                fail(f"the /metrics of {a} lacks {sorted(missing)} or its "
                     f"host/process labels")
        emit({"phase": "cluster", "part": "rollups", "card": card,
              "usage_converged_s": usage_s, "slo_named_s": slo_s,
              "totals": merge_totals(list(local.values())),
              "per_node_generations": {a: t["generations"]
                                       for a, t in local.items()},
              "metrics_cluster_families": len(FAMILIES["cluster"])})
        # 4. a SIGKILL failover: the node that holds the most sessions
        counts = Counter(holder.values())
        victim = max(addrs, key=lambda a: (counts[a], a))
        survivors = [a for a in addrs if a != victim]
        orphans = sorted(s for s, h in holder.items() if h == victim)
        status, _, raw = _req(survivors[0], "POST",
                              f"/sessions/{orphans[0]}/step?async=1",
                              {"steps": n})
        vticket = json.loads(raw)["ticket"] if status == 200 else None
        if vticket is None or _req_json(
                survivors[0], "GET",
                f"/result/{vticket}?wait=1")["status"] != "done":
            fail(f"the ticket on the victim's session answered {status}")
        gens[orphans[0]] += n
        pre = {}
        for sid in orphans:
            status, _, raw = _frame(victim, sid)
            if status != 200:
                fail(f"the pre-kill snapshot of {sid} answered {status}")
            pre[sid] = raw
        vnode = nodes[addrs.index(victim)]
        t_kill = time.perf_counter()
        vnode["proc"].kill()
        vnode["proc"].wait(60)
        window = Counter()
        served = {}
        pending = set(orphans)
        while pending:
            if time.perf_counter() - t_kill > CLUSTER_WAIT_S:
                fail(f"orphans {sorted(pending)} were never served")
            for i, sid in enumerate(sorted(pending)):
                status, headers, raw = _frame(survivors[i % 2], sid)
                if status == 200:
                    if raw != pre[sid]:
                        fail(f"the adopted {sid} differs from its "
                             f"pre-kill snapshot")
                    served[sid] = time.perf_counter() - t_kill
                    pending.discard(sid)
                elif status == 503:
                    ra = headers.get("Retry-After", "")
                    if not ra.isdigit() or int(ra) < 1:
                        fail(f"a 503 in the failover window lacks "
                             f"Retry-After: {headers}")
                    window[503] += 1
                elif status == 404:
                    window[404] += 1    # routed to an adopter not done yet
                else:
                    fail(f"an orphan answered {status}: {raw[:300]!r}")
            time.sleep(0.05)

        def confirmed():
            infos = [_req_json(a, "GET", "/cluster") for a in survivors]
            if not all(i["peers"].get(victim, {}).get("state") == "dead"
                       for i in infos):
                return None
            adopted = sum(i["failover"]["adopted"] for i in infos)
            lost = sum(i["failover"]["lost"] for i in infos)
            return (adopted, lost) if adopted >= len(orphans) else None

        (adopted, lost), _ = _poll(confirmed, "confirmed the victim dead")
        if adopted != len(orphans) or lost:
            fail(f"failover adopted {adopted} and lost {lost} of "
                 f"{len(orphans)} orphans")
        dead = _req_json(survivors[1], "GET", f"/result/{vticket}",
                         want=404)
        if dead != {"error": f"no ticket {vticket!r}", "peer": victim}:
            fail(f"the dead node's ticket answered {dead}")
        # the adopted sessions step on the card: one step each through the
        # other survivor, its adopter's flight record naming its kernel
        adopters = _holders(survivors, orphans)
        for sid in orphans:
            other = next(a for a in survivors if a != adopters[sid])
            out = _req_json(other, "POST", f"/sessions/{sid}/step",
                            {"steps": n})
            gens[sid] += n
            if out["generation"] != gens[sid]:
                fail(f"the adopted {sid} stepped to {out['generation']}")
            rec = _req_json(adopters[sid], "GET",
                            f"/debug/flights?session={sid}&limit=1")
            if [r.get("kernel") for r in rec["flights"]] != [kinds[sid]]:
                fail(f"the adopted {sid} did not step on {kinds[sid]}")
        holder = _holders(survivors, sids)
        _cluster_boards(survivors, holder, gens, plain, "failover")
        emit({"phase": "cluster", "part": "failover", "card": card,
              "victim": victim, "orphans": len(orphans),
              "orphans_by_kernel": dict(Counter(kinds[s] for s in orphans)),
              "kill_to_last_served_s": max(served.values()),
              "kill_to_first_served_s": min(served.values()),
              "failover_adopted": adopted, "failover_lost": lost,
              "window_answers": {str(k): v for k, v in window.items()},
              "dead_ticket_404": True,
              "frames_equal_to_pre_kill": len(orphans)})
        # 5. a drain: one survivor hands every session to the other
        src, dst = survivors
        before = {sid: gens[sid] for sid in sids}
        t0 = time.perf_counter()
        out = _req_json(src, "POST", "/cluster/drain")
        drain_s = time.perf_counter() - t0
        moved = sum(h == src for h in holder.values())
        if not out["ok"] or out["handed_off"] != moved:
            fail(f"the drain handed off {out['handed_off']} of {moved}: "
                 f"{out['errors']}")
        holder = _holders(survivors, sids)
        lost_gens = 0
        for sid in sids:
            got = _req_json(src, "GET", f"/sessions/{sid}/density")
            lost_gens += before[sid] - got["generation"]
        if lost_gens or set(holder.values()) != {dst}:
            fail(f"the drain lost {lost_gens} generations or left "
                 f"sessions on {src}")
        wall, _ = _cluster_turn({s: dst for s in sids}, sids, 1, n,
                                [nodes[addrs.index(dst)]["proc"].pid])
        for sid in sids:
            gens[sid] += n
        _cluster_boards([dst, src], holder, gens, plain, "drain")
        launches = {a: _cluster_stop(nodes[addrs.index(a)])
                    for a in survivors}
        total = Counter()
        for c in launches.values():
            total.update(c)
        if not all(total[k] for k in ("K1", "K2", "K3")):
            fail(f"the surviving nodes launched {dict(total)}")
        emit({"phase": "cluster", "part": "drain", "card": card,
              "from": src, "to": dst, "handed_off": moved,
              "drain_s": drain_s, "lost_generations": 0,
              "steps_after_drain_wall_s": wall,
              "boards_equal_to_plain": len(sids),
              "survivor_launches": launches})
        # the offline scrub over the shared state dir: verify, repair,
        # verify clean
        scrub = [sys.executable, "-m", "mpi_tpu_torch.serve.scrub", state]
        first = subprocess.run(scrub, cwd=ROOT, capture_output=True,
                               text=True, timeout=300)
        repaired = None
        if first.returncode == 1:
            repaired = subprocess.run(scrub + ["--repair"], cwd=ROOT,
                                      capture_output=True, text=True,
                                      timeout=300)
            if repaired.returncode != 0:
                fail(f"the scrub could not repair the state dir: "
                     f"{repaired.stdout[-800:]}")
        elif first.returncode != 0:
            fail(f"the scrub failed: {first.stderr[-800:]}")
        final = subprocess.run(scrub + ["--json"], cwd=ROOT,
                               capture_output=True, text=True, timeout=300)
        report = json.loads(final.stdout) if final.returncode == 0 else {}
        if not report.get("clean"):
            fail(f"the state dir is not clean after the scrub: "
                 f"{final.stdout[-800:]}")
        emit({"phase": "cluster", "part": "scrub", "card": card,
              "first_exit": first.returncode,
              "first_issues": first.stdout.count("issue:"),
              "repaired": (repaired.stdout.count("repaired:")
                           if repaired is not None else 0),
              "records_ok": report["records_ok"],
              "journals_ok": report["journals_ok"], "clean": True,
              "phase_s": time.perf_counter() - t_phase})
    except SystemExit:
        for node in nodes:             # what the nodes said, for the failure
            node["err"].seek(0)
            print(f"chip_smoke: node {node['addr']} stderr: "
                  f"{node['err'].read()[-1500:]}", file=sys.stderr)
        raise
    finally:
        for node in nodes:
            if node["proc"].poll() is None:
                node["proc"].kill()
                node["proc"].wait(60)
            node["proc"].stdout.close()
            node["err"].close()
        shutil.rmtree(work, ignore_errors=True)
    torch.cuda.empty_cache()


# -- phase 10: the plan tuner ------------------------------------------------

# the sizes and rules whose CTA-tile variants (tune/space.py) phase 10
# builds and holds against the plain versions
TUNE_SIZES = (2048, 4096)
TUNE_RULES = (("life", LIFE), ("bosco", BOSCO), ("r2", R2))
# and one dense plan, whose own (unpaired) plane of K2 tiles the tuner
# proposes: PERF.md's dense Bosco path at comm_every 3 (K2 in passes of 3)
TUNE_DENSE = ("bosco", BOSCO, 3)
# the reference's tuning regime (bench.py:2101-2118): 2048² Life with one
# blinker in each of ~1% of the 128² tiles, 200 timed generations after 32
# untimed ones, best of 2
TUNE_REGIME = (2048, 128, 0.01, 200, 2, 32)
# the one-shot CLI under --profile: rows, cols, gap, iterations
PROFILE_RUN = ("4096", "4096", "0", "64")
# the application check: generations a session steps
TUNE_SESSION_STEPS = 40
# the engine kinds whose kernels take a CTA tile, by kernel id
TILE_KINDS = {"bit": "K1", "ltl": "K3", "dense": "K2"}
# K2 tiles larger than the default, which the screen passes at Bosco's
# depth 3 but the tuner's cap leaves out (it keeps the tiles that add
# CTAs): built, held exact and timed beside the proposed ones, because a
# larger tile loads fewer halo cells per owned cell
K2_LARGER_TILES = ([256, 256], [128, 512], [512, 128])


def _tile_variants() -> dict:
    """Every CTA tile ``tune.candidates`` proposes on the card for
    TUNE_RULES at TUNE_SIZES (the paired (comm_every, blocks) plane
    included) and for TUNE_DENSE, as {engine kind: {rule label: [tile,
    ...]}} (kind "bit" is K1, "ltl" K3, "dense" K2)."""
    out = {kind: {} for kind in TILE_KINDS}
    label, rule, k = TUNE_DENSE
    configs = [(lbl, GolConfig(rows=size, cols=size, steps=0, rule=r))
               for size in TUNE_SIZES for lbl, r in TUNE_RULES]
    configs += [(label, GolConfig(rows=size, cols=size, steps=0, rule=rule,
                                  comm_every=k)) for size in TUNE_SIZES]
    for lbl, config in configs:
        for cand in tune.candidates(config, (1, 1)):
            tile = cand.plan.get("blocks")
            if tile is None:
                continue
            kind = backend.plan_engine(apply_plan(config, cand.plan))[0]
            tiles = out[kind].setdefault(lbl, [])
            if list(tile) not in tiles:
                tiles.append(list(tile))
    return out


def _variant_exact(rng, kind: str, rule, tile) -> tuple:
    """(cases, max |variant - plain|) of one tile variant of K1, K3 or K2.
    K1 and K3: both boundaries at gens 1 and the deepest depth on the
    tuner's grid (2048 rows, 64 words) and a ragged one (300 x 67 words),
    a batch of 3 boards, and a padded grid (``col_limit``).  K2: both
    boundaries at gens 1 and the deepest pass (⌊16/r⌋) on a 16-aligned
    grid with interior tiles (2048²) and on ragged widths, not multiples
    of 16, below and above the tile's narrow threshold (its width), and a
    batch of 3 boards."""
    if kind == "dense":
        return _dense_variant_exact(rng, rule, tile)
    wrapper, plain, deepest = {
        "bit": (cuda_bit_step, bit_step_plain, 16),
        "ltl": (cuda_ltl_step, ltl_step_plain, max_gens(rule.radius)),
    }[kind]
    defines = backend.BLOCK_DEFINES[kind](tile)

    def variant(x, rule, boundary, gens, **kw):
        return wrapper(x, rule, boundary, gens, defines=defines, **kw)

    variant.__name__ = f"{wrapper.__name__}[{tile}]"
    cases, err = 0, 0
    for shape in ((2048, 64), (300, 67)):
        for boundary in ("periodic", "dead"):
            for gens in sorted({1, deepest}):
                err = max(err, _compare(variant, plain, _words(rng, shape),
                                        rule, boundary, gens))
                cases += 1
    err = max(err, _compare(variant, plain, _words(rng, (3, 130, 33)), rule,
                            "periodic", deepest))
    x = _words(rng, (200, 40))
    x[:, -1] &= (1 << 7) - 1                 # the pad starts dead
    err = max(err, _compare(variant, plain, x, rule, "dead", deepest,
                            col_limit=32 * 39 + 7))
    return cases + 2, err


def _dense_variant_exact(rng, rule, tile) -> tuple:
    defines = backend.BLOCK_DEFINES["dense"](tile)
    cols = tile[1]

    def variant(x, rule, boundary, gens, **kw):
        return cuda_dense_step(x, rule, boundary, gens, defines=defines, **kw)

    variant.__name__ = f"cuda_dense_step[{tile}]"
    deepest = 16 // rule.radius
    cases, err = 0, 0
    for shape in ((2048, 2048), (300, 333), (300, 600), (300, cols - 5),
                  (300, cols + 77)):
        x = _cells(rng, shape)
        for boundary in ("periodic", "dead"):
            for gens in sorted({1, deepest}):
                err = max(err, _compare(variant, dense_step_plain, x, rule,
                                        boundary, gens))
                cases += 1
    err = max(err, _compare(variant, dense_step_plain,
                            _cells(rng, (3, 130, cols + 21)), rule,
                            "periodic", deepest))
    return cases + 1, err


def _k2_variant_registers(lib) -> list:
    """The registers of a K2 variant's kernels, which may not spill."""
    resources = _build.kernel_resources(lib)
    if len(resources) != 21 or _spills(resources):
        fail(f"K2 variant {lib.name}: expected 21 kernels without spills, "
             f"got {resources}")
    return sorted({r.get("registers") for r in resources})


def _variant_times(card: str, variants: dict) -> list:
    """Each tile variant against the default build, ms per pass in turns:
    K1 (Life) at gens 1 and 8 and K3 at Bosco's gens 1 and R2's gens 1
    and 4, at 2048² and 65536²; K2 (the proposed tiles and
    K2_LARGER_TILES) on Bosco at gens 3 and 1, at 2048² and the dense
    path's 16384²; each with the bound of phase 4."""
    rows = []
    rules = dict(TUNE_RULES)
    packed = {kind: v for kind, v in variants.items() if kind != "dense"}
    for size in (TUNE_SIZES[0], FLAGSHIP):
        x = init_packed(size, size, SEED, device="cuda")
        words = x.numel()
        out = torch.empty_like(x)
        t_bytes = 8 * words / HBM_BYTES_PER_S * 1e3
        for kind, by_rule in packed.items():
            wrapper = cuda_bit_step if kind == "bit" else cuda_ltl_step
            for label, tiles in by_rule.items():
                rule = rules[label]
                if kind == "bit":
                    depths, per_word = (1, MAIN_GENS), word_ops(rule)
                else:
                    depths = sorted({1, max_gens(rule.radius)})
                    per_word = ltl_word_ops_lower(rule)
                for gens in depths:
                    t_ops = gens * words * per_word / INT32_OPS_PER_S * 1e3
                    rows.append(_tile_row(card, kind, wrapper, tiles, x, out,
                                          [size, size], rule, label, gens,
                                          t_bytes, t_ops))
        del x, out
        torch.cuda.empty_cache()
    tiles = sorted({tuple(t) for by in variants["dense"].values() for t in by})
    tiles += [tuple(t) for t in K2_LARGER_TILES]
    label, rule, k = TUNE_DENSE
    for size in (TUNE_SIZES[0], DENSE):
        x = init_dense(size, size, SEED, device="cuda")
        out = torch.empty_like(x)
        t_bytes = 2 * x.numel() / HBM_BYTES_PER_S * 1e3
        for gens in (k, 1):
            t_ops = gens * x.numel() * K2_CELL_OPS / INT32_OPS_PER_S * 1e3
            rows.append(_tile_row(card, "dense", cuda_dense_step,
                                  [list(t) for t in tiles], x, out,
                                  [size, size], rule, label, gens, t_bytes,
                                  t_ops))
        del x, out
        torch.cuda.empty_cache()
    return rows


def _tile_row(card, kind, wrapper, tiles, x, out, grid, rule, label, gens,
              t_bytes, t_ops) -> dict:
    """The default build and each tile variant of one kernel on ``x``, in
    turns, as one ``tile_times`` row."""
    fns = {"default": lambda: wrapper(x, rule, "periodic", gens, out=out)}
    for tile in tiles:
        d = backend.BLOCK_DEFINES[kind](tile)
        fns["x".join(map(str, tile))] = (
            lambda d=d: wrapper(x, rule, "periodic", gens, out=out,
                                defines=d))
    ms = _turns(fns)
    row = {"phase": "tile_times", "card": card, "kernel": TILE_KINDS[kind],
           "rule": label, "grid": grid, "gens": gens, "ms": ms,
           "fastest": min(ms, key=lambda n: sum(ms[n])),
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    emit(row)
    return row


def _tune_board() -> np.ndarray:
    """The reference's tuning board (bench.py:2107-2118): a horizontal
    blinker at the middle of each of the first ~1% of the 128² tiles of a
    square block."""
    N, T, share = TUNE_REGIME[:3]
    board = np.zeros((N, N), dtype=np.uint8)
    k = max(int(round(share * (N // T) ** 2)), 1)
    side = int(np.ceil(np.sqrt(k)))
    for p in range(k):
        r, c = (p // side) * T + T // 2, (p % side) * T + T // 2
        board[r, c - 1:c + 2] = 1
    return board


def _tune_apply(card: str, path: str, config: GolConfig, res) -> dict:
    """The cache on disk, reloaded by a fresh ``SessionManager``: the
    first session's engine holds the entry's plan, a second same-spec
    session compiles nothing, and both boards equal the default plan's
    and the plain version's.  An empty winner is replaced by the best
    measured other candidate, so that a plan is applied."""
    cache = tune.TuneCache(path)
    entry = cache.get(res.key)
    if entry is None:
        fail(f"the tune cache at {path} lacks the sweep's key {res.key}")
    plan, forced = entry["plan"], False
    if not plan:
        others = [p for p in res.probes
                  if p.status == "measured" and p.plan and p.parity
                  and "batch" not in p.plan]
        if not others:
            fail("the sweep measured no candidate besides the default")
        best = max(others, key=lambda p: p.cells_per_s)
        plan, forced = dict(best.plan), True
        cache.record(config, (1, 1), plan, {"forced_by": "chip_smoke.py"})
        cache.save()
    n = TUNE_SESSION_STEPS
    mgr = SessionManager(tune_cache=path, batching=False,
                         async_enabled=False)
    try:
        spec = {"rows": config.rows, "cols": config.cols, "seed": SEED}
        s1 = mgr.create(spec)
        engine = mgr.get(s1["id"]).engine
        if engine.tuned_plan != plan or s1.get("tuned_plan") != plan:
            fail(f"the first session's engine holds {engine.tuned_plan}, "
                 f"the cache {plan}")
        mgr.step(s1["id"], n)
        compiles = engine.compile_count
        s2 = mgr.create(spec)
        mgr.step(s2["id"], n)
        if (not s2["cache_hit"] or mgr.get(s2["id"]).engine is not engine
                or engine.compile_count != compiles):
            fail(f"the second same-spec session compiled: hit "
                 f"{s2['cache_hit']}, compiles {compiles} -> "
                 f"{engine.compile_count}")
        boards = [mgr.snapshot_array(s["id"])[0] for s in (s1, s2)]
        entries = len(mgr.tune_cache)
    finally:
        mgr.shutdown()
    default = backend.build_engine(config)
    want = default.fetch(default.step(default.init_grid(seed=SEED), n))
    plain = unpack(_plain_final("bit", config.rows, config.cols, LIFE, n)
                   ).cpu().numpy()
    if not (np.array_equal(want, plain)
            and all(np.array_equal(b, want) for b in boards)):
        fail(f"the tuned sessions' boards differ from the default plan's "
             f"or the plain version's (plan {plan})")
    return {"plan": plan, "forced_from_best_measured": forced,
            "engine_kind": engine.kind, "engine_blocks": engine.blocks,
            "first_compiles": compiles, "second_compiles": 0,
            "cache_entries": entries, "generations": n,
            "boards_equal_to_default_and_plain": 2}


def _tune_dense(card: str, variants: dict, times: list) -> dict:
    """A K2 tile forced into a tune cache for TUNE_DENSE at 2048² (the
    fastest variant of the 2048² turns at its depth), reloaded by a fresh
    ``SessionManager``: the first session's engine is K2 holding the tile,
    every K2 launch of both sessions goes to the variant's library and
    none to the default build's, a second same-spec session compiles
    nothing, and both boards equal the default plan's and the plain
    version's."""
    label, rule, k = TUNE_DENSE
    size, n = TUNE_SIZES[0], TUNE_SESSION_STEPS
    row = next(r for r in times if r["kernel"] == "K2"
               and r["grid"] == [size, size] and r["gens"] == k)
    named = {"x".join(map(str, t)): list(t)       # the proposed tiles
             for by in variants["dense"].values() for t in by}
    tile = named[min(named, key=lambda nm: sum(row["ms"][nm]))]
    plan = {"blocks": tile}
    macros = backend.BLOCK_DEFINES["dense"](tile)
    config = GolConfig(rows=size, cols=size, steps=0, rule=rule,
                       comm_every=k, seed=SEED)
    loads = {"variant": 0, "other_variant": 0, "default": 0}
    load_variant, load_default = (_build.load_variant_library,
                                  _build.load_library)

    def counted_variant(defines):
        loads["variant" if defines == macros else "other_variant"] += 1
        return load_variant(defines)

    def counted_default():
        loads["default"] += 1
        return load_default()

    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "tune_cache.json")
        cache = tune.TuneCache(path)
        cache.record(config, (1, 1), plan, {"forced_by": "chip_smoke.py"})
        cache.save()
        mgr = SessionManager(tune_cache=path, batching=False,
                             async_enabled=False)
        _build.load_variant_library = counted_variant
        _build.load_library = counted_default
        try:
            _reset_launches()
            spec = {"rows": size, "cols": size, "rule": label,
                    "comm_every": k, "seed": SEED}
            s1 = mgr.create(spec)
            engine = mgr.get(s1["id"]).engine
            if (engine.kernel_id != "K2" or engine.blocks != tile
                    or engine.tuned_plan != plan
                    or s1.get("tuned_plan") != plan):
                fail(f"the tuned dense session's engine is "
                     f"{engine.kernel_id} with tile {engine.blocks} and "
                     f"plan {engine.tuned_plan}; the cache holds {plan}")
            mgr.step(s1["id"], n)
            compiles = engine.compile_count
            s2 = mgr.create(spec)
            mgr.step(s2["id"], n)
            if (not s2["cache_hit"] or mgr.get(s2["id"]).engine is not engine
                    or engine.compile_count != compiles):
                fail(f"the second tuned dense session compiled: hit "
                     f"{s2['cache_hit']}, compiles {compiles} -> "
                     f"{engine.compile_count}")
            torch.cuda.synchronize()
            launches = _launches()
            boards = [mgr.snapshot_array(s["id"])[0] for s in (s1, s2)]
        finally:
            _build.load_variant_library = load_variant
            _build.load_library = load_default
            mgr.shutdown()
    if (not launches["K2"] or loads["variant"] != launches["K2"]
            or loads["default"] or loads["other_variant"]):
        fail(f"the tuned dense sessions launched K2 {launches['K2']} times, "
             f"loading the libraries {loads}: every launch must take the "
             f"tile's variant")
    default = backend.build_engine(config)
    want = default.fetch(default.step(default.init_grid(seed=SEED), n))
    plain = _plain_final("dense", size, size, rule, n).cpu().numpy()
    if not (np.array_equal(want, plain)
            and all(np.array_equal(b, want) for b in boards)):
        fail(f"the tuned dense sessions' boards differ from the default "
             f"plan's or the plain version's (plan {plan})")
    return {"plan": plan, "engine_kind": engine.kind,
            "engine_blocks": engine.blocks, "k2_launches": launches["K2"],
            "library_loads": loads, "first_compiles": compiles,
            "second_compiles": 0, "generations": n,
            "boards_equal_to_default_and_plain": 2}


def _tune_profile(card: str) -> dict:
    """``python -m mpi_tpu_torch.cli ... --profile DIR`` on the card, as a
    subprocess that prints its wrappers' launch counts as it exits: the
    Chrome trace it writes holds K1 records equal to its K1 launches (the
    trace rule, one retake)."""
    def attempt():
        with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) \
                as d:
            logdir = os.path.join(d, "profile")
            proc = subprocess.run(
                [sys.executable, "-c", CLUSTER_NODE_MAIN, *PROFILE_RUN,
                 "--profile", logdir, "--out-dir", d, "--quiet"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                fail(f"the CLI under --profile exited {proc.returncode}: "
                     f"{proc.stderr[-1500:]}")
            counts = [json.loads(line)["launches"]
                      for line in proc.stdout.splitlines()
                      if line.startswith('{"launches"')]
            traces = sorted(Path(logdir).glob("trace-*.json"))
            if len(counts) != 1 or len(traces) != 1:
                fail(f"the CLI under --profile printed {counts} and wrote "
                     f"{traces}")
            counted = counts[0]
            if counted["K2"] or counted["K3"] or not counted["K1"]:
                fail(f"the profiled Life run launched {counted}")
            with open(traces[0]) as fh:
                events = json.load(fh)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            in_trace = {kid: sum(1 for e in kernels
                                 if any(nm in e.get("name", "")
                                        for nm in names))
                        for kid, names in KERNEL_NAMES.items()}
            return ({"K1": counted["K1"]}, {"K1": in_trace["K1"]},
                    {"k1_launches": counted["K1"], "trace_kernels": in_trace,
                     "trace_events": len(events),
                     "trace_bytes": traces[0].stat().st_size,
                     "exit": proc.returncode})

    result, takes, lost = _trace_holds_launches("--profile", attempt)
    return {**result, "takes": takes, "records_lost_on_retaken": lost}


def phase10_tune(card: str, errs: dict) -> dict:
    """The plan tuner on the card: every CTA tile it can propose built in
    one call per kernel (``build_rules`` for K1 and K3, ``build_variants``
    for K2) and held against the plain version, exact; each timed against
    the default build in turns; the reference's tuning regime swept with
    every measured probe's parity; the winner (or the best measured
    candidate) applied from disk by a fresh ``SessionManager``; a K2 tile
    applied the same way to dense Bosco; and the one-shot CLI's
    ``--profile``.  Returns the tile variants by kernel id."""
    t_phase = time.perf_counter()
    variants = _tile_variants()
    rules = dict(TUNE_RULES)
    if not all(variants.values()):
        fail(f"the tuner proposed no tile for a kernel: {variants}")
    build_s = {}
    k2_tiles = [t for ts in variants["dense"].values() for t in ts]
    k2_tiles += K2_LARGER_TILES

    def timed(kid, fn, *args):
        t0 = time.perf_counter()
        res = fn(*args)
        build_s[kid] = time.perf_counter() - t0
        return res

    # K2's variants (nvcc of both common sources each) beside K1's and
    # K3's (one rule header each), all on the host's cores at once
    with ThreadPoolExecutor(1) as pool:
        k2_build = pool.submit(
            timed, "K2", _build.build_variants,
            [backend.BLOCK_DEFINES["dense"](t) for t in k2_tiles])
        for kind in ("bit", "ltl"):
            by_rule = variants[kind]
            timed(TILE_KINDS[kind], _build.build_rules, kind,
                  [rules[label] for label, ts in by_rule.items()
                   for _ in ts],
                  [backend.BLOCK_DEFINES[kind](t)
                   for ts in by_rule.values() for t in ts])
        k2_libs = k2_build.result()
    emit({"phase": "k2_variant_builds", "registers": {
        "x".join(map(str, t)): _k2_variant_registers(lib)
        for t, lib in zip(k2_tiles, k2_libs)}})
    rng = np.random.default_rng(SEED + 10)
    out = {}
    for kind, by_rule in variants.items():
        kid = TILE_KINDS[kind]
        cases, err = 0, 0
        for label, tiles in by_rule.items():
            for tile in tiles:
                c, e = _variant_exact(rng, kind, rules[label], tile)
                cases, err = cases + c, max(err, e)
        out[kid] = {lbl: ["x".join(map(str, t)) for t in tiles]
                    for lbl, tiles in by_rule.items()}
        if kind == "dense":
            for tile in K2_LARGER_TILES:
                c, e = _variant_exact(rng, kind, TUNE_DENSE[1], tile)
                cases, err = cases + c, max(err, e)
        emit({"phase": "variant_vs_plain", "kernel": kid, "cases": cases,
              "max_abs_err": err, "variants": out[kid],
              "not_proposed": (["x".join(map(str, t)) for t in
                                K2_LARGER_TILES] if kind == "dense" else []),
              "build_seconds_all_variants": build_s[kid]})
        errs[kid] = max(errs[kid], err)
        if err:
            fail(f"a {kid} tile variant disagrees with its plain version "
                 f"(tolerance: exact)")
    torch.cuda.synchronize()
    times = _variant_times(card, variants)
    emit({"phase": "tune_dense", "card": card,
          **_tune_dense(card, variants, times)})

    size, _, _, steps, reps, settle = TUNE_REGIME
    config = GolConfig(rows=size, cols=size, steps=0, seed=SEED)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "tune_cache.json")
        _reset_launches()
        t0 = time.perf_counter()
        res = tune.tune_plan(config, board=_tune_board(), steps=steps,
                             reps=reps, settle=settle,
                             cache=tune.TuneCache(path))
        sweep_s = time.perf_counter() - t0
        launches = _launches()
        measured = [p for p in res.probes if p.status == "measured"]
        bad = [p.label for p in measured if p.parity is not True]
        emit({"phase": "tune", "card": card, "grid": [size, size],
              "steps": steps, "reps": reps, "settle": settle,
              "oracle": res.oracle, "sweep_s": sweep_s,
              "launches": launches, "winner": res.winner,
              "winner_label": res.winner_label, "speedup": res.speedup,
              "default_cells_per_s": res.default_cells_per_s,
              "tuned_cells_per_s": res.tuned_cells_per_s,
              "pruned": res.pruned,
              "probes": [[p.label, p.status, p.cells_per_s, p.ops_per_cell,
                          p.parity, p.detail] for p in res.probes]})
        if bad or not launches["K1"]:
            fail(f"tune probes without parity: {bad}; launches {launches}")
        failed = [p.as_dict() for p in res.probes if p.status == "failed"]
        if failed:
            fail(f"tune probes failed: {failed}")
        applied = _tune_apply(card, path, config, res)
    emit({"phase": "tune_apply", "card": card, **applied})
    profile = _tune_profile(card)
    emit({"phase": "tune_profile", "card": card,
          "run": " ".join(PROFILE_RUN), **profile,
          "phase_s": time.perf_counter() - t_phase})
    return out


def _lint_tree() -> dict:
    """``python -m mpi_tpu_torch.analysis`` under this machine's Python:
    its JSON summary, or a failure unless it exits 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "mpi_tpu_torch.analysis", "--format", "json"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"python -m mpi_tpu_torch.analysis exited {proc.returncode}:\n"
             f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}")
    return json.loads(proc.stdout)["summary"]


def phase11_analysis(card: str) -> None:
    """Static analysis on the card: the AST suite over the checkout, the
    launch-level verifier's whole matrix on the card against the CPU's
    blessed fingerprints and the CPU's boards, and one seeded fault that
    ``ir-donation`` must flag there."""
    t_phase = time.perf_counter()
    lint = _lint_tree()
    lint_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    _reset_launches()
    card_rep = ir.run_ir(device="cuda")
    launches = _launches()
    card_s = time.perf_counter() - t0
    if not card_rep.clean:
        fail("launch verifier on the card: "
             + "; ".join([f.format() for f in card_rep.findings]
                         + card_rep.errors))
    missing = [kid for kid, n in launches.items() if not n]
    if missing:
        fail(f"the launch matrix launched no {missing} on the card")
    baseline = ir.load_baseline()
    drifted = [rc.cell.id for rc in card_rep.recorded
               if baseline.get(rc.cell.id, {}).get("fingerprint")
               != rc.fingerprint]
    if drifted or len(card_rep.recorded) != len(baseline):
        fail(f"card fingerprints differ from the CPU-blessed baseline: "
             f"{drifted}")
    t0 = time.perf_counter()
    cpu_rep = ir.run_ir(device="cpu")
    cpu_s = time.perf_counter() - t0
    plain = {rc.cell.id: rc for rc in cpu_rep.recorded}
    unequal = [rc.cell.id for rc in card_rep.recorded
               for mine, theirs in ((rc.boards_1, plain[rc.cell.id].boards_1),
                                    (rc.boards_2, plain[rc.cell.id].boards_2))
               if any(not np.array_equal(a, b) for a, b in zip(mine, theirs))]
    if not cpu_rep.clean or unequal:
        fail(f"launch matrix: boards on the card differ from the plain "
             f"versions' in {unequal}; CPU findings {cpu_rep.findings}")

    # what the disarmed hook costs a wrapper call (host microseconds)
    x = torch.zeros((1, 1), dtype=torch.int32,
                    device=backend.resolve_device())
    n, t0 = 100000, time.perf_counter()
    for _ in range(n):
        with _launch.recording("K1", x, rule=LIFE, boundary="periodic",
                               gens=1, col_limit=None) as rec:
            rec.done(x)
    hook_us = (time.perf_counter() - t0) / n * 1e6

    cell = cell_by_id("seam_1x1")
    engine = backend.build_engine(cell.make_config())
    faulty = record_engine(cell, engine, late_band_seam(engine))
    fault = [f for f in ir_checks.check_donation(faulty)
             if "after the launch took it" in f.message]
    if not fault:
        fail("the seeded late band read was not flagged by ir-donation on "
             "the card")
    emit({"phase": "analysis", "card": card,
          "lint": lint, "lint_s": lint_s,
          "cells": len(card_rep.recorded), "launches": launches,
          "recorded_launches": card_rep.launches(),
          "host_reads": sum(rc.host_read_count for rc in card_rep.recorded),
          "findings": len(card_rep.findings),
          "fingerprints": {rc.cell.id: rc.fingerprint
                           for rc in card_rep.recorded},
          "card_matrix_s": card_s, "cpu_matrix_s": cpu_s,
          "disarmed_hook_us_a_call": hook_us,
          "seeded_fault_findings": len(fault),
          "seeded_fault": fault[0].message,
          "phase_s": time.perf_counter() - t_phase})

# -- phase 12: the mesh on one card ------------------------------------------

# (label, the phase-3 final it must equal, kind, rows, cols, rule,
#  comm_every, steps, mesh, overlap, boundary): the four mesh paths at the
# flagship's width, on virtual shards of the one card
MESH_PATHS = (
    ("life_2x2", ("life", "K1"), "bit", FLAGSHIP, FLAGSHIP, LIFE, MAIN_GENS,
     MAIN_STEPS, (2, 2), False, "periodic"),
    # the mesh of phase 13's two-process Life group, in one process
    ("life_1x2", ("life", "K1"), "bit", FLAGSHIP, FLAGSHIP, LIFE, MAIN_GENS,
     MAIN_STEPS, (1, 2), False, "periodic"),
    ("life_2x2_overlap", ("life", "K1"), "bit", FLAGSHIP, FLAGSHIP, LIFE,
     MAIN_GENS, MAIN_STEPS, (2, 2), True, "periodic"),
    ("bosco_1x2", ("bosco", "K3"), "ltl", FLAGSHIP, FLAGSHIP, BOSCO, 1, 200,
     (1, 2), False, "periodic"),
    # at comm_every 3 (K·r = 15) a mesh takes the bit-sliced stepper, as
    # the reference's does; K·r > 31 is its dense route: K2 in chunks of 3
    ("dense_bosco_2x2", ("bosco", "K2"), "dense", DENSE, DENSE, BOSCO, 7,
     1201, (2, 2), False, "periodic"),
    ("padded_life_1x2", ("padded_life", "K1"), "bit", PADDED, PADDED, LIFE,
     8, 1500, (1, 2), False, "periodic"),
)
MESH_TRACE_PASSES = 4   # passes in each path's profiled window
# label -> a mesh path's cell-updates/s in one process (phase 13 reads it)
MESH_RATES = {}


def _mesh_expected(engine, steps: int, shards=None, band=True) -> dict:
    """The launches of a mesh engine's warm-up and ``steps`` generations:
    every shard one window a pass (five with the overlap body), each window
    in the kernel's chunks (``chunk_gens``), plus one warm-up launch per
    chunk depth; a seam grid adds the band's one launch (``seam``) a pass
    and a warm-up a pass depth, and no K2.  ``shards``: the shards one rank
    of a process group holds (default every shard, one process); ``band``:
    whether it steps the seam band (the rank that owns shard (0, mj-1))."""
    K = min(engine.depth, steps)
    full, rem = divmod(steps, K)
    rule = engine.config.rule
    top = max(chunk_gens(engine.kind, rule, [K]))

    def chunks(k):
        return -(-k // top)

    windows = ((engine.mi * engine.mj if shards is None else shards)
               * (5 if engine.overlap else 1))
    out = {kid: 0 for kid in COUNTERS}
    out[engine.kernel_id] = (
        windows * (full * chunks(K) + (chunks(rem) if rem else 0))
        + len(chunk_gens(engine.kind, rule, engine.depths)))
    if engine.seam and band:
        out["seam"] = full + bool(rem) + len(engine.depths)
    return out


def _mesh_window(engine, grid, k_passes: int):
    """One ``torch.profiler`` window of ``k_passes`` passes: the device
    time of the path's kernel, of the other kernels of K1-K3 and the seam
    band's, and of everything else (the exchange's and the crop's
    copies, the overlap stitch, the seam's gather and stitch), and the
    device's idle share of the window, by the union of the kernels'
    intervals."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()
        with record_function("steady"):
            grid = engine.step(grid, k_passes * engine.depth)
            engine.sync()
    events = prof.events()
    steady = next(e.time_range for e in events if e.name == "steady"
                  and e.device_type == DeviceType.CPU)
    spans = sorted((max(e.time_range.start, steady.start), e.time_range.end,
                    e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != "steady"
                   and e.time_range.end > steady.start)
    own = KERNEL_NAMES[engine.kernel_id]
    ours = [n for names in KERNEL_NAMES.values() for n in names]
    busy, end, kernel_us, other_us, other = 0.0, float("-inf"), 0.0, 0.0, {}
    band_us = 0.0
    for start, stop, name in spans:
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
        if any(n in name for n in own):
            kernel_us += stop - start
        elif any(n in name for n in ours):
            band_us += stop - start
        else:
            other_us += stop - start
            c, us = other.get(name, (0, 0.0))
            other[name] = (c + 1, us + stop - start)
    wall = steady.end - steady.start
    top = sorted(other.items(), key=lambda kv: -kv[1][1])[:6]
    return grid, {
        "passes": k_passes, "wall_ms": wall / 1e3,
        "device_busy_ms": busy / 1e3,
        "idle_share": 1 - busy / wall if spans else None,
        "kernel_ms": kernel_us / 1e3,
        # launches of K1-K3 and the seam kernel other than the path's
        # kernel: the seam band's one launch a pass
        "seam_band_ms": band_us / 1e3,
        # every other kernel: the halo exchange's copies, the tile crops,
        # the overlap stitch and the seam's gather and stitch
        "exchange_copies_ms": other_us / 1e3,
        "other_kernels": [{"name": n[:80], "count": c, "ms": us / 1e3}
                          for n, (c, us) in top]}


def _interior_times(engine) -> dict:
    """The path kernel at its shard window (an interior shard with its
    ghosts on every side, the dense one's width aligned as the exchange
    aligns it), dead boundary, at the deepest chunk a pass launches: ms a
    pass by CUDA events, the plain version's ms, and the bound by phase
    4's formula (bytes: each word or cell read and written once; K1
    ``word_ops``, K3 ``ltl_word_ops_lower``, K2 1.5 a cell-generation)."""
    cfg, kid = engine.config, engine.kernel_id
    rule, K = cfg.rule, cfg.comm_every
    h, w = engine._shard_shape()
    dr = K if engine.kind == "bit" else K * rule.radius
    dc = 1 if engine.bitpacked else K * rule.radius
    width = w + 2 * dc + (-(w + 2 * dc) % 16 if kid == "K2" else 0)
    shape = (h + 2 * dr, width)
    gens = max(chunk_gens(engine.kind, rule, [K]))
    rng = np.random.default_rng(SEED)
    x = _cells(rng, shape) if kid == "K2" else _words(rng, shape)
    kernel, plain = {"K1": (cuda_bit_step, bit_step_plain),
                     "K3": (cuda_ltl_step, ltl_step_plain),
                     "K2": (cuda_dense_step, dense_step_plain)}[kid]
    ms = _pass_ms(kernel, x, rule, gens, reps=10, boundary="dead")
    plain_ms = _plain_ms(plain, x, rule, gens, boundary="dead")
    n = x.numel()
    if kid == "K2":
        t_bytes = 2 * n / HBM_BYTES_PER_S * 1e3
        t_ops = gens * n * K2_CELL_OPS / INT32_OPS_PER_S * 1e3
    else:
        ops = word_ops(rule) if kid == "K1" else ltl_word_ops_lower(rule)
        t_bytes = 8 * n / HBM_BYTES_PER_S * 1e3
        t_ops = gens * n * ops / INT32_OPS_PER_S * 1e3
    del x
    return {"kernel": kid, "window": list(shape), "gens": gens,
            "boundary": "dead", "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def _mesh_path(card: str, path) -> dict:
    (label, final_key, kind, rows, cols, rule, K, steps, shape, overlap,
     boundary) = path
    single = FINALS.get(final_key)
    if single is None:
        fail(f"phase 3 kept no single-device final for {final_key}")
    cfg = GolConfig(rows=rows, cols=cols, steps=steps, seed=SEED, rule=rule,
                    boundary=boundary, mesh_shape=shape, comm_every=K,
                    overlap=overlap)
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, devices=[torch.device("cuda", 0)] * n)
    _reset_launches()
    t0 = time.perf_counter()
    engine = backend.build_engine(
        cfg, mesh=mesh,
        depths=sorted(backend.segment_depths([steps], K)))
    if engine.kind != kind or engine.overlap != overlap:
        fail(f"the {label} mesh path runs {engine.kind} (overlap "
             f"{engine.overlap}), not {kind} (overlap {overlap})")
    grid = engine.init_grid()
    engine.warm_up()
    engine.sync()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    grid = engine.step(grid, steps)
    engine.sync()
    steady_s = time.perf_counter() - t0
    launches = _counted()
    expected = _mesh_expected(engine, steps)
    if launches != expected:
        fail(f"the {label} mesh path launched {launches}, expected "
             f"{expected} (shards x passes x windows + warm-ups)")
    whole = engine.gather(grid)
    digest, pop = _digest(whole), engine.population(grid)
    del whole
    if digest != single["digest"] or pop != single["population"]:
        fail(f"the {label} mesh path's final grid differs from phase 3's "
             f"single-device final (population {pop} vs "
             f"{single['population']})")
    grid, window = _mesh_window(engine, grid, MESH_TRACE_PASSES)
    del grid
    torch.cuda.empty_cache()
    interior = _interior_times(engine)
    torch.cuda.empty_cache()
    rate = rows * cols * steps / steady_s
    return {"path": label, "card": card, "kernel": engine.kernel_id,
            "grid": [rows, cols], "mesh": list(shape), "shards_on": "cuda:0",
            "rule": str(rule), "boundary": boundary, "comm_every": K,
            "overlap": overlap, "steps": steps, "pad_bits": engine.pad_bits,
            "seam": engine.seam, "launches": launches,
            "expected_launches": expected,
            "grid_equal_to_single_device": True, "population": pop,
            "setup_s": setup_s, "steady_s": steady_s,
            "cell_updates_per_s": rate,
            "single_device_steady_s": single["steady_s"],
            "single_device_cell_updates_per_s": single["cell_updates_per_s"],
            "rate_over_single_device": rate / single["cell_updates_per_s"],
            "window": window, "interior": interior}


def _mesh_cli(card: str) -> dict:
    """The CLI's mesh: ``--mesh 1x1`` on the card, ``--mesh 2x2`` on the
    card refused with the reference's message (one card), and ``--mesh
    2x2 --device cpu --save`` whose tiles equal the serial oracle's."""
    rows, cols, gap, steps = 256, 256, 8, 16
    common = [str(rows), str(cols), str(gap), str(steps), "--seed", "5",
              "--quiet", "--save", "--name", "m"]
    want = {it: evolve_np(init_tile_np(rows, cols, 5), it, LIFE, "periodic")
            for it in range(0, steps + 1, gap)}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        KERNELS["K1"].launches = 0
        if cli_main(common + ["--out-dir", os.path.join(d, "one"),
                              "--mesh", "1x1"]) != 0:
            fail("the CLI with --mesh 1x1 on the card failed")
        if KERNELS["K1"].launches == 0:
            fail("the CLI with --mesh 1x1 launched K1 no time")
        one = golio.assemble(os.path.join(d, "one"), "m", steps)
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = cli_main(common + ["--out-dir", os.path.join(d, "card"),
                                    "--mesh", "2x2"])
        refused = err.getvalue().strip()
        want_msg = (f"mesh shape (2, 2) needs 4 devices, have "
                    f"{torch.cuda.device_count()}")
        if torch.cuda.device_count() == 1 and (
                rc != 2 or want_msg not in refused
                or os.path.exists(os.path.join(d, "card"))):
            fail(f"--mesh 2x2 --device cuda on one card: exit {rc}, "
                 f"{refused!r}")
        cpu = os.path.join(d, "cpu")
        if cli_main(common + ["--out-dir", cpu, "--mesh", "2x2", "--device",
                              "cpu"]) != 0:
            fail("the CLI with --mesh 2x2 --device cpu failed")
        tiles = 0
        for it in want:
            for pid in golio.iteration_tile_pids(cpu, "m", it):
                tile, (r0, _, c0, _) = golio.read_tile(
                    golio.find_tile_path(cpu, "m", it, pid))
                h, w = tile.shape
                if not np.array_equal(tile, want[it][r0:r0 + h, c0:c0 + w]):
                    fail(f"--mesh 2x2 tile {pid} at {it} differs from the "
                         f"serial oracle")
                tiles += 1
        if tiles != 4 * len(want) or not np.array_equal(one, want[steps]):
            fail(f"the meshed CLI wrote {tiles} tiles; --mesh 1x1 equal: "
                 f"{np.array_equal(one, want[steps])}")
    return {"mesh_1x1_on_card_equal_to_serial": True,
            "mesh_2x2_on_card_refused": refused,
            "mesh_2x2_cpu_tiles_equal_to_serial": tiles}


def phase12_mesh(card: str) -> None:
    """The single-process mesh on one card: each mesh path against phase
    3's single-device final of its config, with its launches and
    throughput, then the CLI's mesh flags."""
    t_phase = time.perf_counter()
    for path in MESH_PATHS:
        row = _mesh_path(card, path)
        MESH_RATES[row["path"]] = row["cell_updates_per_s"]
        emit({"phase": "mesh", **row})
    emit({"phase": "mesh_cli", "card": card, **_mesh_cli(card),
          "phase_s": time.perf_counter() - t_phase})


# -- phase 13: the multi-process mesh on one card ----------------------------

# (label, the phase-3 final it must equal, kind, rows, cols, rule name,
#  comm_every, steps, mesh, ranks, timed once more without --save): each a
# group of ``python -m mpi_tpu_torch.cli ... --multihost`` processes on the
# one card, one shard a rank
GROUP_PATHS = (
    ("life_1x2", ("life", "K1"), "bit", FLAGSHIP, FLAGSHIP, "life",
     MAIN_GENS, MAIN_STEPS, (1, 2), 2, True),
    ("bosco_1x2", ("bosco", "K3"), "ltl", FLAGSHIP, FLAGSHIP, "bosco", 1,
     200, (1, 2), 2, True),
    # K·r = 35: K2 in chunks of 3, 3 and 1, as phase 12's dense path
    ("dense_bosco_2x2", ("bosco", "K2"), "dense", DENSE, DENSE, "bosco", 7,
     1201, (2, 2), 4, False),
    # K1 with a local col_limit, the seam band gathered across the ranks
    ("padded_life_1x2", ("padded_life", "K1"), "bit", PADDED, PADDED, "life",
     8, 1500, (1, 2), 2, False),
)
GROUP_TIMEOUT_S = 240.0   # the limit of every group, its start included
# each rank runs the CLI as __main__ and prints its wrappers' launch counts
# as it exits (phase 9's wrapper)
RANK_MAIN = CLUSTER_NODE_MAIN
TRAFFIC = re.compile(r"multihost: (\d+) exchanges, (\d+) messages, (\d+) "
                     r"bytes sent, (\d+) bytes staged through the host, "
                     r"(\d+) us in stream syncs, (\d+) us in waits")


def _group(label: str, argv: list, ranks: int, work: str) -> list:
    """One process group of ``ranks`` CLI processes on the card; every
    rank must exit 0 within :data:`GROUP_TIMEOUT_S`, and all are killed
    the moment one fails.  Returns each rank's stdout lines."""
    port = _free_ports(1)[0]
    procs, logs = [], []
    try:
        for p in range(ranks):
            out = open(os.path.join(work, f"{label}.r{p}.out"), "w+")
            err = open(os.path.join(work, f"{label}.r{p}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", RANK_MAIN, *argv, "--device", "cuda",
                 "--multihost", "--coordinator", f"127.0.0.1:{port}",
                 "--num-processes", str(ranks), "--process-id", str(p)],
                cwd=ROOT, stdout=out, stderr=err, text=True))
        deadline = time.perf_counter() + GROUP_TIMEOUT_S
        while any(p.poll() is None for p in procs):
            bad = [i for i, p in enumerate(procs)
                   if p.returncode not in (None, 0)]
            if bad or time.perf_counter() > deadline:
                i = bad[0] if bad else 0
                logs[i][1].seek(0)
                fail(f"the {label} group: rank {i} "
                     f"{'exited ' + str(procs[i].returncode) if bad else 'hung'}"
                     f": {logs[i][1].read()[-1500:]}")
            time.sleep(0.1)
        lines = []
        for i, (p, (out, err)) in enumerate(zip(procs, logs)):
            if p.returncode != 0:
                err.seek(0)
                fail(f"the {label} group: rank {i} exited {p.returncode}: "
                     f"{err.read()[-1500:]}")
            out.seek(0)
            lines.append(out.read().splitlines())
        return lines
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def _rank_report(label: str, p: int, lines: list) -> dict:
    """A rank's transport, launch counts and halo traffic from its
    stdout; the transport must be the host-staged gloo of ranks that share
    a card."""
    transport = [ln for ln in lines if "halo transport" in ln]
    launches = [json.loads(ln)["launches"] for ln in lines
                if ln.startswith('{"launches"')]
    traffic = [TRAFFIC.search(ln) for ln in lines if TRAFFIC.search(ln)]
    if len(transport) != 1 or not transport[0].endswith(
            "halo transport gloo-host-staged") or not launches \
            or not traffic:
        fail(f"the {label} group's rank {p} printed {lines[-6:]}")
    ex, msgs, sent, staged, sync_us, wait_us = (
        int(v) for v in traffic[0].groups())
    return {"rank": p, "transport": transport[0].split("] ", 1)[-1],
            "launches": launches[0], "exchanges": ex, "messages": msgs,
            "bytes_sent": sent, "bytes_staged": staged,
            "stream_sync_s": sync_us / 1e6, "exchange_wait_s": wait_us / 1e6}


def _group_path(card: str, path, work: str, save: bool) -> dict:
    """One full-width group: with ``save`` its final tiles, region by
    region, against phase 3's single-device final (SHA-256 of each
    ``.golp`` body and its population); without, its rate from the CSV
    row of gathered durations.  Either way each rank's launches against
    ``_mesh_expected`` for its one shard, and its transport."""
    (label, final_key, kind, rows, cols, rule_name, K, steps, shape, ranks,
     _) = path
    single = FINALS.get(final_key)
    if single is None or "regions" not in single:
        fail(f"phase 3 kept no single-device regions for {final_key}")
    rule = rule_from_name(rule_name)
    cfg = GolConfig(rows=rows, cols=cols, steps=steps, seed=SEED, rule=rule,
                    mesh_shape=shape, comm_every=K)
    n = shape[0] * shape[1]
    # the plan alone, in this process: what each rank's engine launches
    engine = backend.build_engine(
        cfg, mesh=make_mesh(shape, devices=[torch.device("cuda", 0)] * n),
        depths=sorted(backend.segment_depths([steps], K)))
    if engine.kind != kind:
        fail(f"the {label} group would run {engine.kind}, not {kind}")
    d = os.path.join(work, label)
    os.makedirs(d)
    gap = str(steps) if save else "0"
    argv = [str(rows), str(cols), gap, str(steps), label, "1", "--rule",
            rule_name, "--comm-every", str(K), "--mesh",
            f"{shape[0]}x{shape[1]}", "--seed", str(SEED), "--out-dir", d,
            "--name", label]
    if save:
        argv += ["--save", "--snapshot-format", "golp"]
    t0 = time.perf_counter()
    lines = _group(label, argv, ranks, work)
    wall_s = time.perf_counter() - t0
    per = n // ranks
    band_rank = (shape[1] - 1) // per    # the owner of shard (0, mj-1)
    reports = []
    for p, rank_lines in enumerate(lines):
        rep = _rank_report(label, p, rank_lines)
        want = _mesh_expected(engine, steps, shards=per,
                              band=p == band_rank)
        if rep["launches"] != want:
            fail(f"the {label} group's rank {p} launched "
                 f"{rep['launches']}, expected {want}")
        reports.append(rep)
    passes = -(-steps // K)
    out = {"path": label, "card": card, "kernel": engine.kernel_id,
           "grid": [rows, cols], "mesh": list(shape), "ranks": ranks,
           "rule": rule_name, "comm_every": K, "steps": steps,
           "seam": engine.seam, "save": save, "group_wall_s": wall_s,
           "ranks_report": reports,
           "bytes_staged_a_pass": [r["bytes_staged"] / passes
                                   for r in reports]}
    if save:
        got = []
        for pid in golio.iteration_tile_pids(d, label, steps):
            h, pop = hashlib.sha256(), 0
            with open(golio.find_tile_path(d, label, steps, pid), "rb") as f:
                if f.readline() != golio.GOLP_MAGIC:
                    fail(f"the {label} group's tile {pid} is not .golp")
                f.readline()
                f.readline()
                while chunk := f.read(1 << 26):
                    h.update(chunk)
                    pop += int(POPCOUNT8[np.frombuffer(chunk,
                                                       np.uint8)].sum())
            got.append((pid, h.hexdigest(), pop))
        if got != single["regions"]:
            fail(f"the {label} group's final tiles differ from phase 3's "
                 f"single-device final: {[g[::2] for g in got]} vs "
                 f"{[g[::2] for g in single['regions']]}")
        if sum(pop for _, _, pop in got) != single["population"]:
            fail(f"the {label} group's tiles hold another population")
        out.update(tiles_equal_to_single_device=len(got),
                   population=single["population"])
    else:
        with open(os.path.join(d, f"{label}_compact.csv")) as f:
            csv = f.read().strip().splitlines()
        if len(csv) != 2:
            fail(f"the {label} group wrote {len(csv) - 1} CSV rows, not 1")
        row = [int(v) for v in csv[1].split(",")]
        nos_single, nos_avg, nos_sum = row[6:9]
        if nos_avg != nos_sum // ranks or not nos_sum >= nos_single > 0:
            fail(f"the {label} group's CSV nosetup columns {row[6:9]} are "
                 f"not the gathered table's")
        rate = rows * cols * steps / (nos_avg / 1e6)
        out.update(csv_nosetup_us=row[6:9], steady_s_avg=nos_avg / 1e6,
                   cell_updates_per_s=rate,
                   single_device_cell_updates_per_s=single[
                       "cell_updates_per_s"],
                   rate_over_single_device=rate / single[
                       "cell_updates_per_s"],
                   one_process_cell_updates_per_s=MESH_RATES.get(label),
                   rate_over_one_process=rate / MESH_RATES[label])
    shutil.rmtree(d)
    return out


def _group_profile(card: str, path, work: str) -> dict:
    """The group once more with ``--profile``: one Chrome trace a rank.
    The card's busy share of the steady window: each rank's device events
    (kernels, copies, fills) inside its window, from its first path-kernel
    launch on a shard (not a warm-up's one-word grid) to its last kernel's
    end, summed over the ranks (ranks that share a card without MPS run in
    turns, never at once), over the window that spans every rank's, on
    the clock the traces share (``baseTimeNanoseconds`` + ``ts``)."""
    (label, _, kind, rows, cols, rule_name, K, steps, shape, ranks, _) = path
    kid = {"bit": "K1", "ltl": "K3", "dense": "K2"}[kind]
    d = os.path.join(work, label + "_profiled")
    traces = os.path.join(d, "traces")
    argv = [str(rows), str(cols), "0", str(steps), "--rule", rule_name,
            "--comm-every", str(K), "--mesh", f"{shape[0]}x{shape[1]}",
            "--seed", str(SEED), "--out-dir", d, "--profile", traces]
    lines = _group(label + "_profiled", argv, ranks, work)
    t0s, t1s, busy, per_rank = [], [], 0.0, []
    for p in range(ranks):
        [name] = [f for f in os.listdir(traces)
                  if f.startswith(f"trace-r{p}-")]
        with open(os.path.join(traces, name)) as f:
            trace = json.load(f)
        base = trace.get("baseTimeNanoseconds", 0) / 1e3
        dev = [e for e in trace["traceEvents"]
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
        own = [e for e in dev if e.get("cat") == "kernel"
               and any(n in e["name"] for n in KERNEL_NAMES[kid])]
        shard = [e for e in own if e.get("dur", 0) > 50]
        if not shard:
            fail(f"the {label} group's rank {p} trace holds no {kid} kernel "
                 f"on a shard")
        w0 = min(e["ts"] for e in shard)
        w1 = max(e["ts"] + e["dur"] for e in dev)
        spans = sorted((max(e["ts"], w0), e["ts"] + e.get("dur", 0))
                       for e in dev if e["ts"] + e.get("dur", 0) > w0)
        rank_busy, end = 0.0, float("-inf")
        for a, b in spans:
            rank_busy += max(0.0, b - max(a, end))
            end = max(end, b)
        busy += rank_busy
        t0s.append(base + w0)
        t1s.append(base + w1)
        per_rank.append({
            "rank": p, "window_ms": (w1 - w0) / 1e3,
            "device_busy_ms": rank_busy / 1e3,
            f"{kid}_records": len(own), f"{kid}_ms": sum(
                e["dur"] for e in own) / 1e3,
            "copies_and_fills_ms": sum(e["dur"] for e in dev
                                       if e.get("cat") != "kernel") / 1e3,
            "launches": _rank_report(label, p, lines[p])["launches"]})
    window = max(t1s) - min(t0s)
    shutil.rmtree(d)
    return {"path": label, "card": card, "ranks": ranks,
            "window_ms": window / 1e3, "device_busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window, "ranks_report": per_rank}

def _small_groups(card: str, work: str) -> dict:
    """The CLI's groups at 512² and under, held to the serial oracle by
    ``golio.assemble``: 4 ranks on the default mesh (2x2), a resume written
    on 1x4 and resumed on 2x2 (R2, 4 ranks), and ``--comm-every auto`` (2
    ranks, every rank the same K)."""
    def oracle(rows, cols, steps, rule):
        return evolve_np(init_tile_np(rows, cols, 5), steps, rule,
                         "periodic")

    def check(label, d, name, rows, cols, steps, rule, kid, lines):
        for p, rank_lines in enumerate(lines):
            if _rank_report(label, p, rank_lines)["launches"][kid] == 0:
                fail(f"the {label} group's rank {p} launched {kid} no time")
        if not np.array_equal(golio.assemble(d, name, steps),
                              oracle(rows, cols, steps, rule)):
            fail(f"the {label} group's grid differs from the serial oracle")

    common = ["--save", "--seed", "5"]
    d = os.path.join(work, "four")
    lines = _group("four", ["512", "512", "8", "16", "--out-dir", d]
                   + common, 4, work)
    check("four", d, "run-512x512-16-s5", 512, 512, 16, LIFE, "K1", lines)
    if golio.read_master(golio.master_path(d, "run-512x512-16-s5"))[4] != 4:
        fail("the four-rank group's master header lacks 4 writers")
    d = os.path.join(work, "resume")
    base = ["256", "1024", "8", "8", "--rule", "R2,B10-13,S8-12", "--name",
            "uneven", "--out-dir", d] + common
    _group("resume_write", base + ["--mesh", "1x4"], 4, work)
    lines = _group("resume_read", base + ["--mesh", "2x2", "--resume",
                                          "uneven@8"], 4, work)
    check("resume_read", d, "uneven", 256, 1024, 16, R2, "K3", lines)
    d = os.path.join(work, "auto")
    lines = _group("auto", ["256", "1024", "8", "16", "--comm-every", "auto",
                            "--out-dir", d] + common, 2, work)
    check("auto", d, "run-256x1024-16-s5", 256, 1024, 16, LIFE, "K1", lines)
    policy = {tuple(ln for ln in rank if "comm policy auto" in ln)
              for rank in lines}
    if len(policy) != 1 or len(next(iter(policy))) != 1:
        fail(f"the auto group's ranks resolved {policy}")
    return {"four_ranks_2x2_equal_to_serial": True,
            "resume_1x4_to_2x2_r2_equal_to_serial": True,
            "comm_every_auto": next(iter(policy))[0].split("] ", 1)[-1]}


def phase13_multihost(card: str) -> None:
    """The multi-process mesh on one card: full-width groups held to phase
    3's finals region by region, their rates, then the CLI's small
    groups against the serial oracle."""
    t_phase = time.perf_counter()
    # no rank may start nvcc: every library the groups load is built here
    _build.build()
    _build.build_rules("bit", [LIFE])
    _build.build_rules("ltl", [BOSCO, R2])
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as work:
        for path in GROUP_PATHS:
            emit({"phase": "multihost", **_group_path(card, path, work,
                                                      save=True)})
        for path in GROUP_PATHS:
            if path[-1]:
                emit({"phase": "multihost_rate",
                      **_group_path(card, path, work, save=False)})
        emit({"phase": "multihost_profile",
              **_group_profile(card, GROUP_PATHS[0], work)})
        emit({"phase": "multihost_cli", "card": card,
              **_small_groups(card, work),
              "phase_s": time.perf_counter() - t_phase})


# -- phase 14: serving and tuning on a mesh of virtual shards -----------------

# phase 6's served Life on a mesh: (sessions, size, comm_every, generations
# a request, rounds after the warm one, rounds in the profiled window, mesh)
MESH_SERVE_LIFE = (32, 4096, 8, 8, 20, 4, (2, 2))
# one large session on 2x2: (size, generations before the reads, the
# viewports' side, stream frames, checkpoint_every)
MESH_SESSION = (16384, (2, 2), 16, 1024, 3, 16)
# ticket cohorts of Bosco at 4096²: (label, kernel, comm_every, mesh)
MESH_LTL_SIZE = 4096
MESH_LTL = (("bosco_1x2", "K3", 1, (1, 2)),
            ("dense_bosco_2x2", "K2", 7, (2, 2)))
MESH_TICKET_DEPTHS = (1, 2, 5, 8)
MESH_TICKET_BOARDS = 4
# padded periodic sessions on 1x2 at 4096 x 4090 (2045 cells a shard):
# (label, rule, comm_every); Bosco at 4 has 20 cells of seam band, past
# K2's 16, stepped in chunks of 3 and 1
MESH_PADDED_SHAPE = (4096, 4090)
MESH_PADDED = (("padded_life_1x2", LIFE, 8),
               ("padded_bosco_1x2_k4", BOSCO, 4))
# the tuner on a mesh: (size, mesh, generations a probe, reps)
MESH_TUNE = (4096, (2, 2), 64, 2)


def _virtual(shape) -> list:
    """The one card named once a shard: a mesh of virtual shards of it."""
    return [torch.device("cuda", 0)] * (shape[0] * shape[1])


def _mesh_label(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def _mesh_serve_life(card: str, times: dict) -> dict:
    """Phase 6's served Life on a 2x2 mesh: 32 sessions stepped by 32
    threads, each coalesced round one K1 launch a shard a pass for all
    the boards; every board equal to ``step_batched``'s of the same seeds
    on one device; requests/s against phase 6's 1x1 rate; one profiled
    window's idle share."""
    B, size, k, n, rounds, traced, shape = MESH_SERVE_LIFE
    mgr = SessionManager(EngineCache(), batch_max=B, devices=_virtual(shape))
    try:
        spec = {"rows": size, "cols": size, "rule": "life", "comm_every": k,
                "segments": [1, k], "mesh": _mesh_label(shape)}
        infos = [mgr.create(dict(spec, seed=SEED + b)) for b in range(B)]
        if [i["cache_hit"] for i in infos] != [False] + [True] * (B - 1):
            fail("the mesh Life sessions' creates were not one miss and hits")
        sids = [i["id"] for i in infos]
        engine = mgr.get(sids[0]).engine
        shards = engine.mi * engine.mj
        if (engine.mi, engine.mj) != shape or engine.kernel_id != "K1":
            fail(f"the mesh Life sessions run {engine.kernel_id} on "
                 f"{engine.mi}x{engine.mj}")
        _serve_rounds(mgr, sids, 1, n)      # warms the (n, B) batched step
        builds = _build.builds
        st0, c0 = mgr.batcher.stats(), engine.compile_count
        _reset_launches()
        cpu0 = time.process_time()
        wall = _serve_rounds(mgr, sids, rounds, n)
        cpu = time.process_time() - cpu0
        launches = _launches()
        st1 = mgr.batcher.stats()
        calls = (st1["coalesced_calls"] - st0["coalesced_calls"]
                 + st1["solo_steps"] - st0["solo_steps"])
        warmups = engine.compile_count - c0
        # a step of n = k generations is one pass: one K1 launch a shard,
        # whatever its batch; a width met the first time warms once
        if launches != {"K1": shards * calls + warmups, "K2": 0, "K3": 0} \
                or not calls:
            fail(f"the coalesced mesh rounds launched {launches} for {calls} "
                 f"steps on {shards} shards and {warmups} warm-ups")
        boards = st1["batched_boards"] - st0["batched_boards"]
        _reset_launches()
        trace = _serve_trace(lambda: _serve_rounds(mgr, sids, traced, n))
        traced_launches = _launches()["K1"]
        if _build.builds != builds:
            fail("a kernel was built while the mesh sessions were served")
        _no_faults(mgr, "mesh Life")
        total = n * (1 + rounds + traced)
        if any(mgr.get(s).generation != total for s in sids):
            fail("a mesh Life session lost a step")
        one = backend.build_engine(GolConfig(rows=size, cols=size, steps=0,
                                             rule=LIFE, comm_every=k))
        ref = one.step_batched(one.init_grids(
            seeds=[SEED + b for b in range(B)]), total)
        for b, sid in enumerate(sids):
            if not torch.equal(engine.gather(mgr.get(sid).grid), ref[b]):
                fail(f"mesh Life session {b} differs from the same board "
                     f"stepped on one device")
        del ref
        base = times.get(("serve", "requests_per_s"))
        rps = B * rounds / wall
        row = {"phase": "mesh_serve", "part": "coalesced_life",
               "card": card, "kernel": "K1", "mesh": list(shape),
               "shards_on": "cuda:0", "sessions": B, "grid": [size, size],
               "comm_every": k, "generations_a_request": n,
               "rounds": rounds, "launches": launches, "steps": calls,
               "warmups": warmups,
               "launches_a_round": (launches["K1"] - warmups) / calls,
               "avg_occupancy": boards / max(1, st1["coalesced_calls"]
                                             - st0["coalesced_calls"]),
               "boards_equal_to_one_device": True,
               "builds_while_serving": 0, "serving_wall_s": wall,
               "requests_per_s": rps,
               "requests_per_s_1x1_phase6": base,
               "over_1x1": rps / base if base else None,
               "host_cpu_ms_per_request": cpu * 1e3 / (B * rounds),
               "trace": {**trace, "rounds": traced,
                         "k1_launches": traced_launches,
                         "idle_share": 1 - trace["busy_ms"]
                         / trace["wall_ms"]}}
        emit(row)
        return row
    finally:
        mgr.shutdown()
        torch.cuda.empty_cache()


def _stream_open(address, query: str):
    sock = socket.create_connection(address, timeout=FRONT_WAIT_S)
    sock.sendall(f"GET {query} HTTP/1.1\r\nHost: chip\r\n\r\n".encode())
    buf = bytearray()
    while b"\r\n\r\n" not in buf:
        data = sock.recv(65536)
        if not data:
            fail("the stream closed before its head")
        buf += data
    head, _, rest = bytes(buf).partition(b"\r\n\r\n")
    if b"200" not in head.split(b"\r\n")[0]:
        fail(f"the stream answered {head[:200]!r}")
    return sock, bytearray(rest)


def _mesh_session(card: str) -> dict:
    """A 16384² Life session on 2x2 beside the same session on 1x1 (one
    manager): 1024² viewports across the shard seams (rows and columns
    8192) and across the periodic wrap, a region write across a seam, a
    windowed delta stream folded frame by frame against the keyframe
    stream, and the shard-form checkpoint restored onto 2x2 and onto
    1x1; every read and every board equal to the 1x1 session's."""
    size, shape, gens, side, frames, every = MESH_SESSION
    h = size // 2
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        state = os.path.join(d, "state")
        mgr = SessionManager(EngineCache(), devices=_virtual(shape),
                             state_dir=state, checkpoint_every=every)
        server = thread = None
        socks = []
        try:
            spec = {"rows": size, "cols": size, "rule": "life",
                    "comm_every": 8, "segments": [1, 8],
                    "mesh": _mesh_label(shape)}
            solo_spec = dict(spec, mesh="1x1")
            sid = mgr.create(spec)["id"]
            one = mgr.create(solo_spec)["id"]
            eng = mgr.get(sid).engine
            if (eng.mi, eng.mj) != shape or mgr.get(one).engine.mi != 1:
                fail("the 16384² sessions took the wrong meshes")

            def same() -> bool:
                return _digest(eng.gather(mgr.get(sid).grid)) == _digest(
                    mgr.get(one).grid)

            _reset_launches()
            for s in (sid, one):
                mgr.step(s, gens)
            if not same() or _launches()["K1"] == 0:
                fail("the 2x2 session's board differs from the 1x1 one's")
            wins = [(h - side // 2, h - side // 2, side, side),   # 4 shards
                    (h - side // 2, size // 16, side, side),     # row seam
                    (size // 16, h - side // 2, side, side),     # col seam
                    (size - side // 2, size - side // 3, side, side)]
            read = 0
            t0 = time.perf_counter()
            for win in wins:
                a, ga, _ = mgr.snapshot_window(sid, *win)
                b, gb, _ = mgr.snapshot_window(one, *win)
                if ga != gb or not np.array_equal(a, b):
                    fail(f"viewport {win} of the 2x2 session differs")
                read += a.nbytes
            view_s = time.perf_counter() - t0
            transfers = []
            eng.fetch_window(mgr.get(sid).grid, *wins[0],
                             shard_timer=transfers.append)
            if len(transfers) != 4:
                fail(f"the centre viewport made {len(transfers)} shard "
                     f"transfers, not 4")
            rng = np.random.default_rng(SEED)
            patch = rng.integers(0, 2, size=(side // 2, side),
                                 dtype=np.uint8)
            for s in (sid, one):
                mgr.write_window(s, h - side // 4, size * 3 // 16, patch)
                mgr.step(s, 3)
            if not same():
                fail("the region write across a seam differs from 1x1's")
            # a windowed delta stream against the keyframe stream
            server = make_aio_server(port=0, manager=mgr)
            thread = _serving(server)
            address = server.server_address[:2]
            sw = side // 2     # the streamed window, across all four shards
            q = f"x0={h - sw // 2}&y0={h - sw // 2}&h={sw}&w={sw}&every=1"
            sk, kbuf = _stream_open(address, f"/stream/{sid}?{q}")
            sd, dbuf = _stream_open(address, f"/stream/{sid}?{q}&delta=1")
            socks += [sk, sd]
            keys, deltas = [], []
            _read_chunks(sk, kbuf, keys, 1)
            _read_chunks(sd, dbuf, deltas, 1)
            recon = deltas[0][0]
            delta_frames = 0
            for g in range(1, frames + 1):
                mgr.step(sid, 1)
                mgr.step(one, 1)
                _read_chunks(sk, kbuf, keys, g + 1)
                _read_chunks(sd, dbuf, deltas, g + 1)
                grid, meta = deltas[g]
                if grid is None:
                    recon = wire.apply_delta(recon, meta["tiles"])
                    delta_frames += 1
                else:
                    recon = grid
                want, _, _ = mgr.snapshot_window(one, h - sw // 2,
                                                 h - sw // 2, sw, sw)
                if not (np.array_equal(recon, keys[g][0])
                        and np.array_equal(recon, want)):
                    fail(f"stream frame {g} of the 2x2 session differs")
            if not same():
                fail("the streamed 2x2 session differs from the 1x1 one's")
            # the shard-form checkpoint, restored onto 2x2 and onto 1x1
            mgr.checkpoint_now(sid)
            gen = mgr.get(sid).generation
            digest = _digest(eng.gather(mgr.get(sid).grid))
            rec = recovery.StateStore(state).load_record(sid)
            snap = rec["snapshot"]
            if "shards" not in snap or len(snap["shards"]) != 4:
                fail("the 2x2 session's checkpoint is not in shard form")
        finally:
            for sk in socks:
                sk.close()
            if server is not None:
                _stop_serving(server, thread)
            mgr.shutdown()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        m2 = SessionManager(EngineCache(), devices=_virtual(shape),
                            state_dir=state)
        try:
            restore_s = time.perf_counter() - t0
            e2 = m2.get(sid).engine
            if m2.restored_sessions != 2 or (e2.mi, e2.mj) != shape \
                    or _digest(e2.gather(m2.get(sid).grid)) != digest:
                fail("the 2x2 session did not restore onto 2x2 bit for bit")
        finally:
            m2.shutdown()
        torch.cuda.empty_cache()
        flat = os.path.join(d, "flat")
        recovery.StateStore(flat).save(sid, solo_spec, gen, snap)
        m3 = SessionManager(EngineCache(), state_dir=flat)
        try:
            e3 = m3.get(sid).engine
            if m3.restored_sessions != 1 or e3.mi != 1 \
                    or _digest(m3.get(sid).grid) != digest:
                fail("the 2x2 session's shard-form checkpoint did not "
                     "restore onto 1x1 bit for bit")
        finally:
            m3.shutdown()
        torch.cuda.empty_cache()
    row = {"phase": "mesh_serve", "part": "large_session", "card": card,
           "kernel": "K1", "mesh": list(shape), "grid": [size, size],
           "viewports": [list(w) for w in wins],
           "viewport_bytes": read, "full_read_bytes": size * size,
           "viewport_over_full": read / (len(wins) * size * size),
           "viewports_s": view_s, "centre_viewport_transfers": 4,
           "stream_frames": frames, "delta_frames": delta_frames,
           "checkpoint_shards": len(snap["shards"]),
           "restore_2x2_s": restore_s, "generation": gen,
           "equal_to_1x1": True}
    emit(row)
    return row


def _mesh_tickets(card: str) -> list:
    """Bosco sessions on 1x2 (K3) and dense Bosco on 2x2 at comm_every 7
    (K2), 4096², through tickets of depths 1, 2, 5 and 8, each cohort
    beside the same sessions on 1x1: every board equal."""
    size, per, depths = MESH_LTL_SIZE, MESH_TICKET_BOARDS, MESH_TICKET_DEPTHS
    rows = []
    mgr = SessionManager(EngineCache(), devices=_virtual((2, 2)))
    try:
        for label, kid, k, shape in MESH_LTL:
            spec = {"rows": size, "cols": size, "rule": "bosco",
                    "comm_every": k, "mesh": _mesh_label(shape)}
            sids = [mgr.create(dict(spec, seed=SEED + i))["id"]
                    for i in range(per)]
            solos = [mgr.create(dict(spec, seed=SEED + i, mesh="1x1"))["id"]
                     for i in range(per)]
            eng = mgr.get(sids[0]).engine
            if (eng.mi, eng.mj) != shape or eng.kernel_id != kid:
                fail(f"the {label} sessions run {eng.kernel_id} on "
                     f"{eng.mi}x{eng.mj}")
            _reset_launches()
            t0 = time.perf_counter()
            _ticket_cycle(mgr, sids, depths)
            wall = time.perf_counter() - t0
            launches = _launches()
            _ticket_cycle(mgr, solos, depths)
            for a, b in zip(sids, solos):
                ga, gb = mgr.get(a).grid, mgr.get(b).grid
                if mgr.get(a).generation != sum(depths) or not torch.equal(
                        eng.gather(ga), gb):
                    fail(f"a {label} session differs from its 1x1 twin")
            if not launches[kid]:
                fail(f"the {label} tickets launched no {kid}")
            _no_faults(mgr, label)
            row = {"phase": "mesh_serve", "part": "tickets", "card": card,
                   "path": label, "kernel": kid, "mesh": list(shape),
                   "grid": [size, size], "comm_every": k,
                   "sessions": per, "depths": list(depths),
                   "launches": launches, "wall_s": wall,
                   "board_generations_per_s": per * sum(depths) / wall,
                   "equal_to_1x1": True}
            emit(row)
            rows.append(row)
    finally:
        mgr.shutdown()
        torch.cuda.empty_cache()
    return rows


def _mesh_padded(card: str) -> list:
    """Padded periodic sessions on 1x2 (a width of 2045 cells a shard): Life
    at comm_every 8 (K1 with a local ``col_limit``) and Bosco at
    comm_every 4 (K3; 20 cells of band, past K2's 16), each beside the
    same session on 1x1; a step's launches are the shards' windows and
    the seam band's one launch a pass."""
    rows_, cols = MESH_PADDED_SHAPE
    rows = []
    mgr = SessionManager(EngineCache(), devices=_virtual((1, 2)))
    try:
        for label, rule, k in MESH_PADDED:
            steps = 3 * k + 1
            spec = {"rows": rows_, "cols": cols, "rule": rule.name,
                    "comm_every": k, "mesh": "1x2", "seed": SEED}
            sid = mgr.create(spec)["id"]
            one = mgr.create(dict(spec, mesh="1x1"))["id"]
            eng = mgr.get(sid).engine
            if not eng.seam or eng.kind != ("bit" if rule is LIFE else "ltl"):
                fail(f"the {label} session is not a padded seam mesh: "
                     f"{eng.kind}, seam {eng.seam}")
            eng.ensure_compiled(mgr.get(sid).grid, steps)
            _reset_launches()
            mgr.step(sid, steps)
            launches = _counted()
            # the warm-ups ran before the reset: the step's own launches
            passes = [k] * (steps // k) + [steps % k] * bool(steps % k)
            top = max(chunk_gens(eng.kind, rule, [k]))
            step_only = {kid: 0 for kid in COUNTERS}
            step_only[eng.kernel_id] = eng.mi * eng.mj * sum(
                -(-p // top) for p in passes)
            step_only["seam"] = len(passes)
            if launches != step_only:
                fail(f"the {label} step launched {launches}, expected "
                     f"{step_only}")
            mgr.step(one, steps)
            a, _, _ = mgr.snapshot_array(sid)
            b, _, _ = mgr.snapshot_array(one)
            if not np.array_equal(a, b):
                fail(f"the {label} session differs from its 1x1 twin")
            row = {"phase": "mesh_serve", "part": "padded", "card": card,
                   "path": label, "kernel": eng.kernel_id, "mesh": [1, 2],
                   "grid": [rows_, cols], "comm_every": k,
                   "pad_bits": eng.pad_bits, "steps": steps,
                   "band_depth": k * rule.radius,
                   "launches": launches, "equal_to_1x1": True}
            emit(row)
            rows.append(row)
    finally:
        mgr.shutdown()
        torch.cuda.empty_cache()
    return rows


def _mesh_tune(card: str) -> dict:
    """The tuner on a 2x2 mesh of virtual shards: a few candidates at 4096²
    Life, every measured probe equal to the default plan's board and every
    comm_every > 1 winner through the halo-slab bless; the cache, reloaded
    by a fresh manager, gives a mesh session the winner (the best measured
    candidate written in when the default won), a second session compiles
    nothing, and the tuned grid equals the untuned one."""
    size, shape, steps, reps = MESH_TUNE
    cfg = GolConfig(rows=size, cols=size, steps=0, seed=SEED, rule=LIFE,
                    mesh_shape=shape)
    cands = [tune.Candidate(),
             tune.Candidate({"comm_every": 2}, "comm_every=2"),
             tune.Candidate({"comm_every": 8}, "comm_every=8")]
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "tune.json")
        cache = tune.TuneCache(path)
        t0 = time.perf_counter()
        res = tune.tune_plan(cfg, devices=_virtual(shape), steps=steps,
                             reps=reps, cache=cache, cands=cands)
        tune_s = time.perf_counter() - t0
        bad = [p.as_dict() for p in res.probes
               if p.status != "measured" or not p.parity]
        if bad:
            fail(f"a mesh tuning probe failed: {bad}")
        plan = res.winner
        if not plan:
            best = max((p for p in res.probes if p.plan),
                       key=lambda p: p.cells_per_s)
            plan = dict(best.plan)
            cache.record(cfg, shape, plan, {"written_in": True},
                         device="cuda")
            cache.save()
        mesh = make_mesh(shape, devices=_virtual(shape))
        tuned = backend.build_engine(cfg, mesh=mesh, tune=path)
        if tuned.tuned_plan != plan:
            fail(f"the mesh engine took {tuned.tuned_plan}, not {plan}")
        ok, why = tune.tuner._slab_depths_ok(tuned, tuned.init_grid(),
                                             tuned.depth)
        if not ok:
            fail(f"the mesh winner fails the halo-slab bless: {why}")
        mgr = SessionManager(EngineCache(), devices=_virtual(shape),
                             tune_cache=path)
        try:
            spec = {"rows": size, "cols": size, "mesh": _mesh_label(shape)}
            a = mgr.create(dict(spec, seed=SEED))
            eng = mgr.get(a["id"]).engine
            if eng.tuned_plan != plan:
                fail(f"the tuned mesh session took {eng.tuned_plan}")
            mgr.step(a["id"], steps)
            c0 = eng.compile_count
            b = mgr.create(dict(spec, seed=SEED + 1))
            mgr.step(b["id"], steps)
            if not b["cache_hit"] or eng.compile_count != c0 \
                    or mgr.get(b["id"]).engine is not eng:
                fail(f"the second tuned mesh session compiled "
                     f"{eng.compile_count - c0} times")
            untuned = backend.build_engine(cfg, mesh=mesh)
            g = untuned.step(untuned.init_grid(seed=SEED), steps)
            if not torch.equal(untuned.gather(g),
                               eng.gather(mgr.get(a["id"]).grid)):
                fail("the tuned mesh session's grid differs from the "
                     "untuned engine's")
        finally:
            mgr.shutdown()
    torch.cuda.empty_cache()
    row = {"phase": "mesh_tune", "card": card, "grid": [size, size],
           "mesh": list(shape), "steps": steps, "reps": reps,
           "winner": res.winner, "applied_plan": plan,
           "written_in": not res.winner, "key": res.key,
           "default_cells_per_s": res.default_cells_per_s,
           "speedup": res.speedup,
           "probes": [p.as_dict() for p in res.probes],
           "slab_bless": True, "second_session_compiles": 0,
           "grid_equal_to_untuned": True, "tune_s": tune_s}
    emit(row)
    return row


def _mesh_halo_probe(card: str) -> dict:
    """The devmem sampler's halo probe on the serving mesh: a 2x2 session
    on a manager with a full ``Obs``; each telemetry sample times one
    ghost-ring exchange, ``mpi_tpu_halo_exchange_seconds{mesh="2x2"}``."""
    obs = Obs()
    mgr = SessionManager(EngineCache(), devices=_virtual((2, 2)), obs=obs)
    try:
        obs.arm_telemetry(manager=mgr, start=False)
        obs.arm_flight(manager=mgr)
        mgr.create({"rows": MESH_LTL_SIZE, "cols": MESH_LTL_SIZE,
                    "mesh": "2x2"})
        for _ in range(3):
            obs.telemetry.sample_once()
        count = obs.devmem.halo_hist.count(mesh="2x2")
        st = obs.devmem.stats()
        if count != 3 or st["errors"]:
            fail(f"the halo probe sampled {count} times ({st})")
        scrape = obs.metrics.render()
        lines = [ln for ln in scrape.splitlines()
                 if ln.startswith("mpi_tpu_halo_exchange_seconds_sum")]
    finally:
        mgr.shutdown()
    row = {"phase": "mesh_obs", "card": card, "mesh": [2, 2],
           "halo_samples": count, "scrape": lines}
    emit(row)
    return row


def _mesh_batch_times(card: str) -> list:
    """Each batched shard window of :func:`_mesh_batch_windows` timed (ms a
    pass by CUDA events, ping-ponging), beside its plain version's ms and
    the bound of phase 4's formula; no PyTorch call computes a step."""
    rng = np.random.default_rng(SEED)
    pairs = {"K1": (cuda_bit_step, bit_step_plain),
             "K3": (cuda_ltl_step, ltl_step_plain),
             "K2": (cuda_dense_step, dense_step_plain)}
    rows = []
    for kid, cases in _mesh_batch_windows().items():
        kernel, plain = pairs[kid]
        for label, shape, rule, gens, limit in cases:
            x = _cells(rng, shape) if kid == "K2" else _words(rng, shape)
            kw = {} if kid == "K2" else {"col_limit": limit}
            if limit is not None:
                x = x & pad_mask(shape[-1], limit, "cuda")
            one_pass = _ping_pong(
                lambda a, b: kernel(a, rule, "dead", gens, out=b, **kw), x)
            for _ in range(3):
                one_pass()
            ms = _events_ms(one_pass, 10)
            plain_ms = _plain_ms(plain, x, rule, gens, boundary="dead", **kw)
            n = x.numel()
            if kid == "K2":
                t_bytes = 2 * n / HBM_BYTES_PER_S * 1e3
                t_ops = gens * n * K2_CELL_OPS / INT32_OPS_PER_S * 1e3
            else:
                ops = word_ops(rule) if kid == "K1" \
                    else ltl_word_ops_lower(rule)
                t_bytes = 8 * n / HBM_BYTES_PER_S * 1e3
                t_ops = gens * n * ops / INT32_OPS_PER_S * 1e3
            row = {"phase": "mesh_batch_times", "card": card,
                   "kernel": kid, "window": label, "shape": list(shape),
                   "rule": str(rule), "gens": gens, "col_limit": limit,
                   "boundary": "dead", "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": max(t_bytes, t_ops),
                   "bound_by": "bytes" if t_bytes >= t_ops
                   else "operations", "library_ms": None}
            emit(row)
            rows.append(row)
            del x
        torch.cuda.empty_cache()
    return rows


def phase14_mesh_serve(card: str, times: dict) -> None:
    """Serving and tuning on a mesh of virtual shards of the one card."""
    t_phase = time.perf_counter()
    laps = {}

    def lap(name, t0):
        laps[name] = time.perf_counter() - t0
        return time.perf_counter()

    t0 = time.perf_counter()
    _mesh_serve_life(card, times)
    t0 = lap("served_life", t0)
    _mesh_session(card)
    t0 = lap("large_session", t0)
    _mesh_tickets(card)
    t0 = lap("tickets", t0)
    _mesh_padded(card)
    t0 = lap("padded", t0)
    _mesh_tune(card)
    t0 = lap("tune", t0)
    _mesh_halo_probe(card)
    t0 = lap("halo_probe", t0)
    _mesh_batch_times(card)
    lap("batch_times", t0)
    emit({"phase": "mesh_serve_seconds", "card": card, **laps,
          "phase_s": time.perf_counter() - t_phase})


def main() -> int:
    card = phase0_card()
    seconds, t0 = {}, time.perf_counter()

    def lap(name):
        nonlocal t0
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    phase1_build()
    lap("build")
    errs = phase2_exact()
    lap("kernel_vs_plain")
    launches = phase3_main_paths()
    lap("main_paths")
    times = phase4_times(card)
    lap("times")
    phase5_traces(card)
    lap("traces")
    phase6_serve(card, times)
    lap("serve")
    phase7_obs(card)
    lap("obs_native")
    phase8_front(card, times)
    lap("front")
    phase9_cluster(card)
    lap("cluster")
    tiles = phase10_tune(card, errs)
    lap("tune")
    phase11_analysis(card)
    lap("analysis")
    phase12_mesh(card)
    lap("mesh")
    phase13_multihost(card)
    lap("multihost")
    phase14_mesh_serve(card, times)
    lap("mesh_serve")
    emit({"phase": "seconds", **seconds})
    k1 = times["K1", MAIN_GENS]
    k2 = times["K2", DENSE_PATH[2]]
    k3 = times["K3", LTL_PATHS[0][0], LTL_PATHS[0][2]]
    print(card, flush=True)
    emit({"kernels": [
        {"name": "K1 bit_step", "route": "cuda",
         "source": "mpi_tpu_torch/csrc/bitlife.cu",
         "replaces": "mpi_tpu/ops/pallas_bitlife.py:351",
         "launches": launches["K1"], "max_abs_err": errs["K1"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"],
         "library_ms": None, "tile_variants": tiles["K1"]},
        {"name": "K2 dense_step", "route": "cuda",
         "source": "mpi_tpu_torch/csrc/stencil.cu",
         "replaces": "mpi_tpu/ops/pallas_stencil.py:285",
         "launches": launches["K2"], "max_abs_err": errs["K2"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"],
         "bound_ms": k2["bound_ms"], "bound_by": k2["bound_by"],
         "library_ms": k2["library_ms"], "tile_variants": tiles["K2"]},
        {"name": "K3 ltl_step", "route": "cuda",
         "source": "mpi_tpu_torch/csrc/bitltl.cu",
         "replaces": "mpi_tpu/ops/pallas_bitltl.py:264",
         "launches": launches["K3"][LTL_PATHS[0][0]],
         "max_abs_err": errs["K3"],
         "ms": k3["ms"], "plain_ms": k3["plain_ms"],
         "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
         "library_ms": None, "tile_variants": tiles["K3"]},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
