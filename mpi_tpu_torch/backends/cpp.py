"""ctypes bindings for the native C++ engine (``backends/native/golcore.cpp``),
the port's copy of ``mpi_tpu.backends.cpp``.

Two execution modes, the host backends a user asks for by name:

* serial (``gol_evolve``, backend ``cpp``) — the C++ oracle;
* parallel (``gol_evolve_par``, backend ``cpp-par``) — tile-decomposed
  multi-worker engine with explicit ghost-ring halo exchange; ``workers``
  plays the role of ``mpirun -np``.

Both run on the host only: no ``cuda`` run or session ever lands here.

The shared library and the standalone ``gol_native`` binary are built on
demand with ``make`` (g++, no external deps) into ``backends/native/`` of
the port; Python never reimplements the kernel.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

from mpi_tpu_torch.models.rules import LIFE, Rule
from mpi_tpu_torch.parallel.mesh import choose_mesh_shape

NATIVE_DIR = os.path.join(os.path.dirname(__file__), "native")
SO_PATH = os.path.join(NATIVE_DIR, "libgolcore.so")
BIN_PATH = os.path.join(NATIVE_DIR, "gol_native")
_SOURCES = ("golcore.cpp", "gol_main.cpp", "Makefile")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

_u8p = ctypes.POINTER(ctypes.c_uint8)


def _stale() -> bool:
    """A built file is missing or older than a source (the reference's
    rebuild-on-mtime rule, over both targets)."""
    newest = max(os.path.getmtime(os.path.join(NATIVE_DIR, f))
                 for f in _SOURCES)
    return any(not os.path.exists(p) or os.path.getmtime(p) < newest
               for p in (SO_PATH, BIN_PATH))


def build_native() -> None:
    """Build ``libgolcore.so`` and ``gol_native`` where either is missing
    or stale.  One build at a time across processes (an ``flock`` on the
    native directory: test workers may all ask at once); ``make`` runs on
    copies of the sources in a fresh directory beside them, and the built
    files are moved into place with ``os.replace``, so no process ever
    loads a half-written library, and one that has the old library loaded
    keeps it."""
    if not _stale():
        return
    fd = os.open(NATIVE_DIR, os.O_RDONLY)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        if not _stale():
            return  # another process built it while this one waited
        tmp = tempfile.mkdtemp(prefix=".build-", dir=NATIVE_DIR)
        try:
            for f in _SOURCES:
                shutil.copy2(os.path.join(NATIVE_DIR, f), tmp)
            subprocess.run(["make", "-C", tmp], check=True,
                           capture_output=True, text=True)
            for p in (SO_PATH, BIN_PATH):
                os.replace(os.path.join(tmp, os.path.basename(p)), p)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    finally:
        fcntl.flock(fd, fcntl.LOCK_UN)
        os.close(fd)


def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the native engine; idempotent."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build_native()
        lib = ctypes.CDLL(SO_PATH)
        lib.gol_init.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.gol_init.restype = None
        lib.gol_step.argtypes = [
            _u8p, _u8p, ctypes.c_int64, ctypes.c_int64, _u8p, _u8p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.gol_step.restype = None
        lib.gol_evolve.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p, _u8p,
            ctypes.c_int, ctypes.c_int,
        ]
        lib.gol_evolve.restype = None
        lib.gol_evolve_par.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p, _u8p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.gol_evolve_par.restype = ctypes.c_int
        _lib = lib
        return lib


def _as_u8p(a: np.ndarray):
    return a.ctypes.data_as(_u8p)


def _check_grid(grid: np.ndarray) -> np.ndarray:
    if grid.dtype != np.uint8 or grid.ndim != 2:
        raise ValueError(f"grid must be 2D uint8, got {grid.dtype} {grid.shape}")
    return np.ascontiguousarray(grid)


def init_tile_cpp(
    rows: int, cols: int, seed: int, row_offset: int = 0, col_offset: int = 0
) -> np.ndarray:
    lib = load_library()
    out = np.empty((rows, cols), dtype=np.uint8)
    lib.gol_init(_as_u8p(out), rows, cols, seed & 0xFFFFFFFF, row_offset, col_offset)
    return out


def step_cpp(grid: np.ndarray, rule: Rule = LIFE, boundary: str = "periodic") -> np.ndarray:
    lib = load_library()
    grid = _check_grid(grid)
    bt, st = rule.tables()
    out = np.empty_like(grid)
    lib.gol_step(
        _as_u8p(grid), _as_u8p(out), grid.shape[0], grid.shape[1],
        _as_u8p(bt), _as_u8p(st), rule.radius, 1 if boundary == "periodic" else 0,
    )
    return out


def evolve_cpp(
    grid: np.ndarray, steps: int, rule: Rule = LIFE, boundary: str = "periodic"
) -> np.ndarray:
    """Serial native evolution (the C++ oracle)."""
    lib = load_library()
    out = _check_grid(grid).copy()
    bt, st = rule.tables()
    lib.gol_evolve(
        _as_u8p(out), out.shape[0], out.shape[1], steps,
        _as_u8p(bt), _as_u8p(st), rule.radius, 1 if boundary == "periodic" else 0,
    )
    return out


def plan_tiles(shape: Tuple[int, int], workers: int, radius: int) -> Tuple[int, int]:
    """Largest worker-tile mesh with <= workers tiles that divides the grid
    and keeps each tile at least radius cells per side (the native engine's
    ghost slabs are filled from a single neighbor)."""
    if workers <= 0:
        workers = min(os.cpu_count() or 1, 16)
    ti, tj = choose_mesh_shape(workers)
    while shape[0] % ti or shape[1] % tj or \
            shape[0] // ti < radius or shape[1] // tj < radius:
        workers -= 1
        if workers <= 1:
            return (1, 1)
        ti, tj = choose_mesh_shape(workers)
    return ti, tj


def evolve_par_cpp(
    grid: np.ndarray,
    steps: int,
    rule: Rule = LIFE,
    boundary: str = "periodic",
    workers: int = 0,
    tiles: Optional[Tuple[int, int]] = None,
) -> np.ndarray:
    """Multi-worker native evolution over a tile mesh (one thread per tile)."""
    lib = load_library()
    out = _check_grid(grid).copy()
    if tiles is None:
        ti, tj = plan_tiles(out.shape, workers, rule.radius)
    else:
        ti, tj = tiles
    bt, st = rule.tables()
    rc = lib.gol_evolve_par(
        _as_u8p(out), out.shape[0], out.shape[1], steps,
        _as_u8p(bt), _as_u8p(st), rule.radius, 1 if boundary == "periodic" else 0,
        ti, tj,
    )
    if rc != 0:
        raise ValueError(
            f"native engine rejected tile mesh {ti}x{tj} for grid {out.shape} "
            f"radius {rule.radius} (rc={rc})"
        )
    return out
