"""Build the port's CUDA kernels from ``mpi_tpu_torch/csrc`` at first use.

Three kinds of library, all compiled by ``nvcc`` for Hopper (``sm_90a``)
with a plain C interface and loaded with ``ctypes``:

* the common library (:func:`load_library`): every ``csrc/*.cu`` that is
  not built per rule, which is ``stencil.cu`` (kernel K2) and
  ``errors.cu`` (the error text), one nvcc process per source, all
  started together, linked into one shared library;
* variants of the common library (:func:`load_variant_library`): the
  same sources built with ``-D`` macros, which pick K2's CTA tile
  (``K2_ROWS``, ``K2_COLS``; ``ops/cuda_stencil.py:block_defines``).  K2
  reads its rule at run time, so a variant is keyed by the sources and
  its macros, never by a rule; :func:`build_variants` builds many of
  them in parallel nvcc processes, one a variant;
* one library per rule (:func:`load_rule_library`) for the kernels that
  have the rule compiled in, :data:`PER_RULE`: ``"bit"`` is
  ``csrc/bitlife.cu`` (kernel K1, radius 1) and ``"ltl"`` is
  ``csrc/bitltl.cu`` (kernel K3, radius 2..7).  The rule is straight-line
  code that ``ops/bit_codegen.py`` or ``ops/ltl_codegen.py`` emits into a
  header, which the source includes by a macro (``BIT_RULE_HEADER``,
  ``LTL_RULE_HEADER``); further ``-D`` macros fix the radius and pick a
  variant of the kernel.  :func:`build_rules` builds many rules, or many
  variants, in parallel nvcc processes (2-4 s for one rule on the H100's
  host).

Libraries land in ``build/mpi_tpu_torch/`` at the root of the checkout,
named by a hash of what went into them (sources, flags, macros, and for a
rule its canonical text and its generated header), so an edited source
or a new rule is built on the next run and an unchanged one is reused;
rules with equal birth and survive sets share a library whatever their
names.  Beside each, ``<library>.ptxas.txt`` keeps ptxas's report of its
kernels' registers and spills (:func:`kernel_resources` reads it).  The
engine builds at warm-up (``backends/cuda.py:Engine.warm_up``), which is
setup, never inside the stepping.

There is no fallback: without ``nvcc``, or when a build fails, this
raises with the compiler's message.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence, Union

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "mpi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# K3's horizontal sum by radius: 0 carry-save adders over the 2r+1 shifted
# copies, 1 doubling window sums; each the faster of the two on the H100
# (chip_smoke.py phase 4 builds both and times them in turns)
LTL_HSUM = {2: 0, 3: 1, 4: 1, 5: 1, 6: 1, 7: 1}


@dataclass(frozen=True)
class PerRule:
    """A kernel that is built once per rule: its source, the macro that
    names the generated rule header, the module whose ``rule_header(rule)``
    emits that header (imported when a rule is built), the macros a rule
    fixes, its C entry point with the count of its int
    arguments between the two grid pointers and the stream, and the
    argument types of its other C functions (a variant's library may lack
    some)."""

    source: Path
    header_macro: str
    codegen: str
    defines: Callable  # rule -> {macro: value}
    entry: str
    int_args: int
    helpers: tuple = ()


PER_RULE = {
    # gol_bit_step(in, out, B, H, NW, gens, periodic, col_limit, stream)
    "bit": PerRule(CSRC_DIR / "bitlife.cu", "BIT_RULE_HEADER",
                   "mpi_tpu_torch.ops.bit_codegen",
                   lambda rule: {}, "gol_bit_step", 6, (
                       ("gol_bit_ctas_per_sm", [ctypes.c_int]),
                       ("gol_bit_tile", [ctypes.c_int]
                        + [ctypes.POINTER(ctypes.c_int)] * 2),
                       ("gol_bit_set_masks", [ctypes.c_uint] * 2))),
    # gol_ltl_step(in, out, B, H, NW, radius, gens, periodic, col_limit,
    #              stream)
    "ltl": PerRule(CSRC_DIR / "bitltl.cu", "LTL_RULE_HEADER",
                   "mpi_tpu_torch.ops.ltl_codegen",
                   lambda rule: {"LTL_RADIUS": rule.radius,
                                 "LTL_HSUM": LTL_HSUM[rule.radius]},
                   "gol_ltl_step", 7),
}


class BuildError(RuntimeError):
    """The CUDA kernels could not be built."""


# nvcc processes started by this process (the traces check that none
# starts while the engine steps)
builds = 0
# libraries loaded by this process (load_library, load_variant_library,
# load_rule_library: each library once), and the host seconds those loads
# took, their builds included (the benchmark's kernel_load_s reads these)
loads = 0
load_seconds = 0.0


def sources() -> list:
    """The sources of the common library."""
    per_rule = {kernel.source for kernel in PER_RULE.values()}
    return sorted(p for p in CSRC_DIR.glob("*.cu") if p not in per_rule)


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


def library_path(defines: Optional[dict] = None) -> Path:
    """Where the common library built from the current sources lives; with
    ``defines``, the variant built with those ``-D`` macros (the same
    sources' hash and the macros: no rule)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    if not defines:
        return BUILD_DIR / f"libmpi_tpu_torch_{h.hexdigest()[:16]}.so"
    h.update(repr(sorted(defines.items())).encode())
    return BUILD_DIR / f"libmpi_tpu_torch_dense_{h.hexdigest()[:16]}.so"


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


Defines = Optional[Union[dict, Sequence[Optional[dict]]]]


def _rule_parts(kind: str, rule, defines: Optional[dict]):
    """(library path, header name, header text, macros) of ``rule``'s
    build of the per-rule kernel ``kind``; ``defines`` adds to or
    replaces the macros the rule fixes."""
    kernel = PER_RULE[kind]
    macros = {**kernel.defines(rule), **(defines or {})}
    header = importlib.import_module(kernel.codegen).rule_header(rule)
    from mpi_tpu_torch.ops.gates import rule_key

    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for part in (kernel.source.read_bytes(), rule_key(rule).encode(),
                 repr(sorted(macros.items())).encode(), header.encode()):
        h.update(part)
    digest = h.hexdigest()[:16]
    return (BUILD_DIR / f"libmpi_tpu_torch_{kind}_r{rule.radius}_{digest}.so",
            f"{kind}_rule_{digest}.cuh", header, macros)


def _per_rule_defines(rules, defines: Defines) -> list:
    if defines is None or isinstance(defines, dict):
        return [defines] * len(rules)
    if len(defines) != len(rules):
        raise ValueError("one set of macros per rule, or one for all")
    return list(defines)


def rule_library_path(kind: str, rule, defines: Optional[dict] = None) -> Path:
    """Where the library of the per-rule kernel ``kind`` (``"bit"`` or
    ``"ltl"``) for ``rule`` lives: equal for rules with equal counts and
    radius, whatever their names."""
    return _rule_parts(kind, rule, defines)[0]


def build_rules(kind: str, rules, defines: Defines = None,
                jobs: int = 0) -> list:
    """Build the library of the per-rule kernel ``kind`` for every rule in
    ``rules`` that is not built yet, ``jobs`` nvcc processes at a time
    (default: one per CPU), and return their paths in order.  ``defines``
    adds ``-D`` macros that pick a variant of the kernel (e.g.
    ``{"LTL_HSUM": 0}``): one dict for every rule, or a list with one
    entry per rule, so that several variants of one rule build together."""
    kernel = PER_RULE[kind]
    parts = [_rule_parts(kind, rule, d)
             for rule, d in zip(rules, _per_rule_defines(rules, defines))]
    todo = {}
    for rule, (lib, name, text, macros) in zip(rules, parts):
        if not lib.exists():
            todo[lib] = (rule, name, text, macros)
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmds = []
        for lib, (rule, name, text, macros) in todo.items():
            (BUILD_DIR / name).write_text(text)
            cmd = [nvcc, *NVCC_FLAGS, f"-D{kernel.header_macro}={name}",
                   *(f"-D{k}={v}" for k, v in sorted(macros.items())),
                   f"-I{BUILD_DIR}", "-shared", str(kernel.source)]
            cmds.append((lib, cmd, f"{kernel.source.name} for {rule}"))
        _run_all(cmds, jobs)
    return [lib for lib, *_ in parts]


def build_variants(defines: Sequence[dict], jobs: int = 0) -> list:
    """Build the variant of the common library for every set of macros in
    ``defines`` that is not built yet (e.g. ``{"K2_ROWS": 64, "K2_COLS":
    128}``), one nvcc process a variant (both sources, linked), ``jobs`` at
    a time (default: one per CPU), and return their paths in order."""
    paths = [library_path(d) for d in defines]
    todo = {lib: d for d, lib in zip(defines, paths) if not lib.exists()}
    if todo:
        nvcc = find_nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        _run_all([(lib, [nvcc, *NVCC_FLAGS,
                         *(f"-D{k}={v}" for k, v in sorted(d.items())),
                         "-shared", *map(str, sources())],
                   f"the common sources with {d}")
                  for lib, d in todo.items()], jobs)
    return paths


def _run_all(todo: list, jobs: int = 0) -> None:
    """Run each ``(library, nvcc command, what)`` of ``todo`` into a
    temporary file, ``jobs`` at a time (default: one per CPU), and move it
    to its library when it succeeds, its ptxas report beside it; raise
    :class:`BuildError` with every failure's message."""
    jobs = jobs or os.cpu_count() or 1
    queue, running, failed = list(todo), [], []
    while queue or running:
        while queue and len(running) < jobs:
            lib, cmd, what = queue.pop(0)
            tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
            running.append((lib, tmp, what, _nvcc([*cmd, "-o", str(tmp)])))
        lib, tmp, what, proc = running.pop(0)
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({proc.returncode}) on {what}:\n"
                          f"{stderr}{stdout}")
            continue
        ptxas_log(lib).write_text(stdout + stderr)
        os.replace(tmp, lib)
    if failed:
        raise BuildError("\n".join(failed))


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


def _counted(load: Callable[[], ctypes.CDLL]) -> ctypes.CDLL:
    """``load()``, its host seconds added to :data:`load_seconds` (a
    failed load's too) and the library to :data:`loads`."""
    global loads, load_seconds
    t0 = time.perf_counter()
    try:
        lib = load()
    finally:
        load_seconds += time.perf_counter() - t0
    loads += 1
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The built common library with its C signatures declared (pointers
    and the stream as ``c_void_p``, so ctypes never truncates them to 32
    bits)."""
    return _counted(lambda: _dense_signatures(ctypes.CDLL(str(build()))))


_VARIANT_LIBS: dict = {}  # macros -> variant of the common library


def load_variant_library(defines: dict) -> ctypes.CDLL:
    """The variant of the common library built with the macros
    ``defines`` (K2's CTA tile), built at first use and loaded once."""
    key = tuple(sorted(defines.items()))
    if key not in _VARIANT_LIBS:
        _VARIANT_LIBS[key] = _counted(lambda: _dense_signatures(
            ctypes.CDLL(str(build_variants([defines])[0]))))
    return _VARIANT_LIBS[key]


def _dense_signatures(lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.gol_dense_step.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, i32,
                                   ctypes.POINTER(ctypes.c_uint), ptr]
    lib.gol_dense_step.restype = ctypes.c_int
    return _error_string(lib)


def _error_string(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.gol_error_string.argtypes = [ctypes.c_int]
    lib.gol_error_string.restype = ctypes.c_char_p
    return lib


_RULE_LIBS: dict = {}  # (kind, canonical rule text, macros) -> library


def load_rule_library(kind: str, rule,
                      defines: Optional[dict] = None) -> ctypes.CDLL:
    """The library of the per-rule kernel ``kind`` for ``rule``, built at
    first use and loaded once per rule (rules with equal counts and radius
    share it)."""
    from mpi_tpu_torch.ops.gates import rule_key

    key = (kind, rule_key(rule), tuple(sorted((defines or {}).items())))
    if key not in _RULE_LIBS:
        _RULE_LIBS[key] = _counted(
            lambda: _rule_signatures(
                PER_RULE[kind],
                ctypes.CDLL(str(build_rules(kind, [rule], defines)[0]))))
    return _RULE_LIBS[key]


def _rule_signatures(kernel: PerRule, lib: ctypes.CDLL) -> ctypes.CDLL:
    ptr = ctypes.c_void_p
    entry = getattr(lib, kernel.entry)
    entry.argtypes = [ptr, ptr] + [ctypes.c_int] * kernel.int_args + [ptr]
    entry.restype = ctypes.c_int
    for name, argtypes in kernel.helpers:
        try:
            helper = getattr(lib, name)
        except AttributeError:  # this variant's library has none
            continue
        helper.argtypes, helper.restype = argtypes, ctypes.c_int
    return _error_string(lib)
