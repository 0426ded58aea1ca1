"""Build the port's CUDA kernels from ``mpi_tpu_torch/csrc`` at first use.

Two kinds of library, both compiled by ``nvcc`` for Hopper (``sm_90a``)
with a plain C interface and loaded with ``ctypes``:

* the common library (:func:`load_library`): every ``csrc/*.cu`` but
  ``bitltl.cu`` (kernels K1 and K2), one nvcc process per source, all
  started together, linked into one shared library;
* one library per Larger-than-Life rule (:func:`load_ltl_library`):
  ``csrc/bitltl.cu`` (kernel K3) compiled for the rule's radius alone,
  with the rule itself as straight-line code that ``ops/ltl_codegen.py``
  emits into a header, included by the macro ``LTL_RULE_HEADER``.
  :func:`build_ltl` builds many rules in parallel nvcc processes.

Libraries land in ``build/mpi_tpu_torch/`` at the root of the checkout,
named by a hash of what went into them (sources, flags, and for a rule
its canonical text and generated header), so an edited source or a new
rule is built on the next run and an unchanged one is reused.  Beside
each, ``<library>.ptxas.txt`` keeps ptxas's report of its kernels'
registers and spills (:func:`kernel_resources` reads it).  The engine
builds at warm-up (``backends/cuda.py:Engine.warm_up``), which is setup,
never inside the stepping.

There is no fallback: without ``nvcc``, or when a build fails, this
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


# kernel K3's source, built once per rule, not into the common library
LTL_SOURCE = CSRC_DIR / "bitltl.cu"
# K3's horizontal sum by radius: 0 carry-save adders over the 2r+1 shifted
# copies, 1 doubling window sums; each the faster of the two on the H100
# (chip_smoke.py phase 4 builds both and times them in turns)
LTL_HSUM = {2: 0, 3: 1, 4: 1, 5: 1, 6: 1, 7: 1}


class BuildError(RuntimeError):
    """The CUDA kernels could not be built."""


# nvcc processes started by this process (the traces check that none
# starts while the engine steps)
builds = 0


def sources() -> list:
    """The sources of the common library."""
    return sorted(p for p in CSRC_DIR.glob("*.cu") if p != LTL_SOURCE)


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
    procs = [_nvcc([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)])
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


def _nvcc(cmd: list) -> subprocess.Popen:
    global builds
    builds += 1
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _ltl_parts(rule, hsum: int):
    """(library path, header name, header text) of ``rule``'s K3 build."""
    from mpi_tpu_torch.ops.ltl_codegen import rule_header, rule_key

    header = rule_header(rule)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (LTL_SOURCE.read_bytes(), rule_key(rule).encode(),
                 f"hsum={hsum}".encode(), header.encode()):
        h.update(part)
    digest = h.hexdigest()[:16]
    return (BUILD_DIR / f"libmpi_tpu_torch_ltl_r{rule.radius}_{digest}.so",
            f"ltl_rule_{digest}.cuh", header)


def _hsum(rule, hsum: Optional[int]) -> int:
    return LTL_HSUM[rule.radius] if hsum is None else hsum


def ltl_library_path(rule, hsum: Optional[int] = None) -> Path:
    """Where the K3 library of ``rule`` lives: equal for rules with equal
    counts and radius, whatever their names."""
    return _ltl_parts(rule, _hsum(rule, hsum))[0]


def build_ltl(rules, hsum: Optional[int] = None, jobs: int = 0) -> list:
    """Build the K3 library of every rule in ``rules`` that is not built
    yet, ``jobs`` nvcc processes at a time (default: one per CPU), and
    return their paths in order.  ``hsum`` picks the horizontal sum
    (default ``LTL_HSUM`` for each rule's radius)."""
    parts = [_ltl_parts(rule, _hsum(rule, hsum)) for rule in rules]
    todo = {}
    for rule, (lib, name, text) in zip(rules, parts):
        if not lib.exists():
            todo[lib] = (rule, name, text)
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = jobs or os.cpu_count() or 1
        queue, running, failed = list(todo.items()), [], []
        while queue or running:
            while queue and len(running) < jobs:
                lib, (rule, name, text) = queue.pop(0)
                (BUILD_DIR / name).write_text(text)
                tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
                cmd = [nvcc, *NVCC_FLAGS, f"-DLTL_RADIUS={rule.radius}",
                       f"-DLTL_RULE_HEADER={name}",
                       f"-DLTL_HSUM={_hsum(rule, hsum)}",
                       f"-I{BUILD_DIR}", "-shared", "-o", str(tmp),
                       str(LTL_SOURCE)]
                running.append((lib, tmp, rule, _nvcc(cmd)))
            lib, tmp, rule, proc = running.pop(0)
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed ({proc.returncode}) on "
                              f"{LTL_SOURCE.name} for {rule}:\n{stderr}{stdout}")
                continue
            ptxas_log(lib).write_text(stdout + stderr)
            os.replace(tmp, lib)
        if failed:
            raise BuildError("\n".join(failed))
    return [lib for lib, _, _ in parts]


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
    for fn in (lib.gol_bit_step, lib.gol_dense_step):
        fn.restype = ctypes.c_int
    return _error_string(lib)


def _error_string(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gol_error_string.argtypes = [ctypes.c_int]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


_LTL_LIBS: dict = {}  # (canonical rule text, hsum) -> loaded library


def load_ltl_library(rule, hsum: Optional[int] = None) -> ctypes.CDLL:
    """The K3 library of ``rule``, built at first use and loaded once per
    rule (rules with equal counts and radius share it)."""
    from mpi_tpu_torch.ops.ltl_codegen import rule_key

    key = (rule_key(rule), _hsum(rule, hsum))
    if key not in _LTL_LIBS:
        lib = ctypes.CDLL(str(build_ltl([rule], key[1])[0]))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gol_ltl_step.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ptr]
        lib.gol_ltl_step.restype = ctypes.c_int
        _LTL_LIBS[key] = _error_string(lib)
    return _LTL_LIBS[key]
