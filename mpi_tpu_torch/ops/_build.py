"""Build the port's CUDA kernels from ``mpi_tpu_torch/csrc`` at first use.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one process
per source, all started together, and links the objects into one shared
library with a plain C interface, which :func:`load_library` loads with
``ctypes``.  The library lands in ``build/mpi_tpu_torch/`` at the root of
the checkout, named by a hash of the sources and flags, so an edited
source is rebuilt on the next run and an unchanged one is reused.  Beside
it, ``<library>.ptxas.txt`` keeps ptxas's report of each kernel's registers
and spills (:func:`kernel_resources` reads it).

There is no fallback: without ``nvcc``, or when the build fails, this
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mpi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class BuildError(RuntimeError):
    """The CUDA kernels could not be built."""


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    ``nvcc`` on ``PATH``."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(cand) and os.access(cand, os.X_OK):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the "
            "CUDA kernels of mpi_tpu_torch are compiled from "
            f"{CSRC_DIR} with nvcc at first use"
        )
    return found


def library_path() -> Path:
    """Where the library built from the current sources lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libmpi_tpu_torch_{h.hexdigest()[:16]}.so"


def ptxas_log(library: Path) -> Path:
    """Where ptxas's report for ``library`` is kept."""
    return library.with_suffix(".ptxas.txt")


def build(out: Optional[Path] = None) -> Path:
    """Compile the sources into ``out`` (default :func:`library_path`)
    unless that library exists."""
    out = out or library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"tmp{os.getpid()}"
    objs = [out.parent / f"{src.stem}.{tag}.o" for src in sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for src, obj in zip(sources(), objs)]
    logs, failed = [], []
    for src, proc in zip(sources(), procs):
        stdout, stderr = proc.communicate()
        logs.append(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {src.name}:\n"
                          f"{stderr}{stdout}")
    tmp = out.with_suffix(f".{tag}.so")
    try:
        if failed:
            raise BuildError("\n".join(failed))
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise BuildError(f"nvcc failed ({proc.returncode}): "
                             f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
        ptxas_log(out).write_text("".join(logs))
        os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


def kernel_resources(library: Path) -> list:
    """Each kernel's registers per thread and spill bytes, from the ptxas
    report kept beside ``library``: dicts of ``kernel`` (the name with its
    radius template argument, e.g. ``ltl_step_kernel<5>``), ``registers``,
    ``spill_stores``, ``spill_loads`` and ``stack_bytes``."""
    out = []
    for line in ptxas_log(library).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            # the name follows its length in the mangled form: "...15bit_step_kernel"
            k = re.search(r"\d([a-z_]+_kernel)(?:ILi(\d+)E)?", m[1])
            out.append({"kernel": k[1] + (f"<{k[2]}>" if k[2] else "")
                        if k else m[1]})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and out:
            out[-1].update(stack_bytes=int(m[1]), spill_stores=int(m[2]),
                           spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m and out:
            out[-1]["registers"] = int(m[1])
    return out


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes never truncates them to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_bit_step.argtypes = [ptr, ptr, i32, i32, i32, i32, ctypes.c_uint,
                                 ctypes.c_uint, ptr]
    lib.gol_dense_step.argtypes = [ptr, ptr, i32, i32, i32, i32, i32,
                                   ctypes.POINTER(ctypes.c_uint), ptr]
    lib.gol_ltl_step.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr, i32,
                                 i32, ptr]
    for fn in (lib.gol_bit_step, lib.gol_dense_step, lib.gol_ltl_step):
        fn.restype = ctypes.c_int
    lib.gol_error_string.argtypes = [ctypes.c_int]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib
