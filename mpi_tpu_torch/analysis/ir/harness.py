"""Run a matrix cell for real under the recorder: cell -> RecordedCell.

The reference traces each cell's stepper abstractly (``jax.make_jaxpr``)
and never runs it.  Eager PyTorch has no abstract trace, so the port
builds the cell's engine with ``backends/cuda.py:build_engine`` on the
given device (the exact dispatch the serve stack uses), warms it outside
the window, and runs two steps of ``depth`` generations (one grid, or a
stacked batch of B boards) with two recorders armed:

* the **launch recorder** (``ops/_launch.py:arm``): every call of the
  kernel wrappers ``cuda_bit_step`` (K1), ``cuda_ltl_step`` (K3),
  ``cuda_dense_step`` (K2) and ``parallel/seam.py:fused_band`` (``seam``:
  the seam band, its input the pass's input and its ``out`` the pass's
  output on one device, a mesh's gathered blocks of them) logs the
  kernel, the rule's canonical text, boundary, gens, shape, dtype and
  ``col_limit``, and the storage of its input and of its ``out``.  On the
  CPU a wrapper runs the kernel's plain version and copies into ``out`` as
  the kernel writes it (or returns a fresh tensor where the kernel
  allocates one), so the record is the same on both devices: a record
  blessed on the CPU is the card's record too.  Only these records enter
  the fingerprint (:mod:`.canon`);
* the **exchange record** (``ops/_launch.py:record_exchange``): on a
  mesh, every ppermute of the halo exchange (``parallel/halo.py``) logs
  its mesh axis, (src, dst) pairs and slab shape, which ``ir-collective``
  judges and the fingerprint keeps;
* the **op recorder**, a ``TorchDispatchMode``: every aten op of the step
  outside a wrapper call, with the storages it reads and writes and
  whether it reads a value back to the host.  It serves the donation and
  host-read contracts (:mod:`.checks`) and never enters the fingerprint:
  which aten ops a line of PyTorch becomes moves with torch's version.

A cell on a mesh larger than (1, 1) runs on that many virtual shards of
the one device; its step's entry and returned storages are those of shard
(0, 0), and every shard's entry storage is kept besides
(``Step.entry_shards``) for the donation check.  Storages are held alive for the whole recording, so a storage's address
names it for the window (no buffer is freed and its address reused by
another).  On the card each step of a cell without sparse stepping also
runs under ``torch.cuda.set_sync_debug_mode("error")``: a synchronising
call there raises.
"""

from __future__ import annotations

import contextlib
import io
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mpi_tpu_torch.analysis.ir.canon import CanonResult, canonicalize
from mpi_tpu_torch.analysis.ir.matrix import Cell
from mpi_tpu_torch.config import GolConfig, plan_signature
from mpi_tpu_torch.ops import _launch
from mpi_tpu_torch.ops.gates import rule_key

# ops whose result's size depends on the data: on the card each waits for
# the device to learn it
_DATA_SIZED = frozenset({"nonzero", "masked_select"})
# schema return types that are host values, not tensors
_HOST_TYPES = frozenset({"number", "Scalar", "bool", "int", "float"})


class HarnessError(RuntimeError):
    """A cell could not be run (no such device, engine build failed) —
    surfaced as a runner internal error (exit 2), never a silent pass."""


@dataclass(frozen=True)
class Ref:
    """A tensor's place: the recorder's number of its storage, and its
    element offset in it."""

    storage: int
    offset: int = 0


@dataclass(frozen=True)
class Launch:
    """One wrapper call: what the kernel was asked to do, and where."""

    kernel: str          # "K1", "K2" or "K3"
    rule: str            # the rule's canonical text (ops/gates.py:rule_key)
    boundary: str
    gens: int
    shape: Tuple[int, ...]
    dtype: str
    col_limit: Optional[int]
    src: Ref
    out: Ref


@dataclass(frozen=True)
class Exchange:
    """One ppermute of a halo exchange."""

    axis: str                              # mesh axis name ("gi", "gj")
    pairs: Tuple[Tuple[int, int], ...]     # (src, dst) axis positions
    shape: Tuple[int, ...]                 # the slab each source sends


@dataclass(frozen=True)
class Op:
    """One aten op outside a wrapper call."""

    name: str                  # e.g. "aten::index_select"
    reads: Tuple[int, ...]     # storages read (views read nothing)
    writes: Tuple[int, ...]    # storages written in place
    host_read: bool            # a value comes back to the host


@dataclass
class Step:
    """The records of one engine step, in order."""

    entry: Ref
    returned: Optional[Ref] = None
    # on a mesh, the entry storage of every shard, shard (0, 0)'s included
    entry_shards: Tuple[int, ...] = ()
    events: List[object] = field(default_factory=list)  # Launch|Exchange|Op
    # a sparse engine's own account of the step (``evolve.phases`` and
    # ``evolve.reads``, ops/activity.py): the phases it ran, and the host
    # reads it made to choose them; empty and 0 elsewhere
    phases: Dict[str, int] = field(default_factory=dict)
    counted_reads: int = 0

    @property
    def launches(self) -> List[Launch]:
        return [e for e in self.events if isinstance(e, Launch)]

    @property
    def exchanges(self) -> List[Exchange]:
        return [e for e in self.events if isinstance(e, Exchange)]

    @property
    def host_reads(self) -> List[Op]:
        return [e for e in self.events if isinstance(e, Op) and e.host_read]


class _Storages:
    """Numbers storages in order of first sight and keeps each alive, so
    that no address is reused inside the window."""

    def __init__(self):
        self._ids = {}
        self._keep = []

    def ref(self, t: torch.Tensor) -> Ref:
        st = t.untyped_storage()
        # an empty storage has no address of its own: a number each time
        key = (t.device.type, st.data_ptr() if st.nbytes() else -len(
            self._keep))
        sid = self._ids.get(key)
        if sid is None:
            sid = self._ids[key] = len(self._ids)
            self._keep.append(st)
        return Ref(sid, t.storage_offset())


def _tensors(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, (list, tuple)):
        for v in value:
            if isinstance(v, torch.Tensor):
                yield v


class _LaunchScope:
    def __init__(self, rec: "Recorder", kernel: str, x: torch.Tensor,
                 meta: dict):
        self.rec, self.kernel, self.x, self.meta = rec, kernel, x, meta

    def __enter__(self):
        self.rec._inside += 1
        return self

    def done(self, out: torch.Tensor) -> None:
        m, x = self.meta, self.x
        self.rec.step.events.append(Launch(
            kernel=self.kernel, rule=rule_key(m["rule"]),
            boundary=m["boundary"], gens=int(m["gens"]),
            shape=tuple(x.shape), dtype=str(x.dtype).replace("torch.", ""),
            col_limit=m["col_limit"], src=self.rec.storages.ref(x),
            out=self.rec.storages.ref(out)))

    def __exit__(self, *exc) -> bool:
        self.rec._inside -= 1
        return False


class Recorder(TorchDispatchMode):
    """Both recorders of one cell: armed in ``ops/_launch.py`` for the
    wrappers' calls, and entered as a dispatch mode for the aten ops
    between them."""

    def __init__(self):
        super().__init__()
        self.storages = _Storages()
        self.step: Optional[Step] = None
        self._inside = 0

    # -- the launch recorder (ops/_launch.py:recording) -----------------

    def launch(self, kernel: str, x: torch.Tensor, meta: dict):
        return _LaunchScope(self, kernel, x, meta)

    def exchange(self, axis: str, pairs, shape) -> None:
        if self.step is not None:
            self.step.events.append(Exchange(
                axis, tuple(tuple(p) for p in pairs), tuple(shape)))

    # -- the op recorder --------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside == 0 and self.step is not None:
            self._op(func, args, kwargs, out)
        return out

    def _op(self, func, args, kwargs, out) -> None:
        schema = func._schema
        reads, writes, devices = [], [], set()
        for i, arg in enumerate(schema.arguments):
            value = args[i] if i < len(args) else kwargs.get(arg.name)
            for t in _tensors(value):
                devices.add(t.device.type)
                alias = arg.alias_info
                if alias is not None and alias.is_write:
                    writes.append(self.storages.ref(t).storage)
                elif alias is None:
                    reads.append(self.storages.ref(t).storage)
        outs = list(_tensors(out))
        for t in outs:
            self.storages.ref(t)
        name = schema.name.split("::", 1)[-1]
        host = (name in _DATA_SIZED
                or any(str(r.type) in _HOST_TYPES for r in schema.returns)
                or ("cpu" in {t.device.type for t in outs}
                    and devices - {"cpu"}))
        self.step.events.append(Op(schema.name, tuple(reads), tuple(writes),
                                   bool(host)))

    # -- one step ---------------------------------------------------------

    def record(self, fn: Callable, entry: torch.Tensor, raw: Callable,
               sync_debug: bool, shards=()):
        """Run ``fn()`` (one engine step of ``entry``) with both recorders
        armed; returns its result and the :class:`Step`.  ``raw`` maps a
        step's result to its grid tensor; ``shards``: on a mesh, every
        shard tensor of the entry grid."""
        self.step = Step(entry=self.storages.ref(entry), entry_shards=tuple(
            self.storages.ref(t).storage for t in shards))
        previous = _launch.arm(self)
        debug = contextlib.nullcontext()
        if sync_debug:
            debug = _sync_debug_error()
        try:
            with self, debug:
                result = fn()
        finally:
            _launch.arm(previous)
        step, self.step = self.step, None
        step.returned = self.storages.ref(raw(result))
        return result, step


@contextlib.contextmanager
def _sync_debug_error():
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(previous)


@dataclass
class RecordedCell:
    """Everything the checks consume about one recorded cell."""

    cell: Cell
    config: GolConfig
    engine: object
    signature: tuple
    steps: List[Step]
    canon: CanonResult
    # each board after one step and after both, as host uint8 arrays
    boards_1: List[np.ndarray]
    boards_2: List[np.ndarray]

    @property
    def fingerprint(self) -> str:
        return self.canon.fingerprint

    @property
    def group_key(self) -> tuple:
        """The collision unit: the serve layer keeps one engine per
        signature and steps it at any (depth, B), so two cells may only
        be required to agree when signature, depth AND batch all match."""
        return (self.signature, self.cell.depth, self.cell.batch)

    @property
    def collectives(self) -> List[Exchange]:
        """Every ppermute of the recorded steps, in order."""
        return [e for s in self.steps for e in s.exchanges]

    @property
    def launches_by_kernel(self) -> Counter:
        return Counter(ln.kernel for s in self.steps for ln in s.launches)

    @property
    def host_read_count(self) -> int:
        return sum(len(s.host_reads) for s in self.steps)


def _boards(engine, grid, batched: bool) -> List[np.ndarray]:
    if batched:
        return engine.fetch_batched(grid)
    return [engine.fetch(grid)]


def record_engine(cell: Cell, engine, evolve=None) -> RecordedCell:
    """The recording half of :func:`record_cell`, split out so tests can
    seed a tampered stepper (``evolve``, in ``Engine._evolve``'s place)
    against the real engine contract."""
    if evolve is not None:
        engine._evolve = evolve
    batched = cell.batch > 0
    if batched:
        grid = engine.init_grids(seeds=[cell.seed + i
                                        for i in range(cell.batch)])
        engine.ensure_compiled_batched(grid, cell.depth)

        def step(g):
            return engine.step_batched(g, cell.depth)
    else:
        grid = engine.init_grid()
        engine.ensure_compiled(grid, cell.depth)

        def step(g):
            return engine.step(g, cell.depth)
    engine.sync()
    on_card = engine.device.type == "cuda"
    sparse = engine.sparse_plan is not None
    # a grid on a mesh is a nested list of shards: shard (0, 0) names it
    meshed = engine.mi * engine.mj > 1
    raw = (lambda g: g[0][0]) if meshed else engine.raw_grid
    rec = Recorder()
    steps, boards = [], []
    for _ in range(2):
        if sparse:
            phases0 = Counter(engine._evolve.phases)
            reads0 = engine._evolve.reads
        grid, rec_step = rec.record(
            lambda g=grid: step(g), raw(grid), raw,
            sync_debug=on_card and not sparse,
            shards=[t for row in grid for t in row] if meshed else ())
        if sparse:
            ran = Counter(engine._evolve.phases) - phases0
            rec_step.phases = {":".join(map(str, k)): n
                               for k, n in sorted(ran.items())}
            rec_step.counted_reads = engine._evolve.reads - reads0
        steps.append(rec_step)
        boards.append(_boards(engine, grid, batched))
    return RecordedCell(
        cell=cell, config=engine.config, engine=engine,
        signature=plan_signature(engine.config, (engine.mi, engine.mj)),
        steps=steps, canon=canonicalize(steps),
        boards_1=boards[0], boards_2=boards[1])


def record_cell(cell: Cell, device) -> RecordedCell:
    """Build the cell's engine on ``device`` (on a mesh, on that many
    virtual shards of it) and record two steps of it."""
    from mpi_tpu_torch.backends.cuda import build_engine
    from mpi_tpu_torch.parallel.mesh import make_mesh

    try:
        mesh = None
        if cell.devices_needed > 1:
            mesh = make_mesh(cell.mesh,
                             devices=[torch.device(device)]
                             * cell.devices_needed)
        # the planning notes build_engine prints belong to the cell, not
        # to the verifier's report
        with contextlib.redirect_stderr(io.StringIO()):
            engine = build_engine(cell.make_config(), device=device,
                                  mesh=mesh)
        return record_engine(cell, engine)
    except HarnessError:
        raise
    except Exception as e:
        raise HarnessError(f"cell {cell.id}: {type(e).__name__}: {e}") from e
