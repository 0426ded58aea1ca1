"""Nothing the benchmark runs imports JAX or the JAX package, compared by
whole top-level module names (the program's own name begins with the JAX
package's), and nothing reads the JAX package's measurement files."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.run import FORBIDDEN, loaded_forbidden

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _sources():
    out = []
    for d, _, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_jax_package_import(path):
    assert not set(_roots(path)) & set(FORBIDDEN)


@pytest.mark.parametrize("path", [p for p in _sources()
                                  if p != os.path.abspath(__file__)],
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_reads_no_reference_measurements(path):
    text = open(path).read()
    for name in ("mpi_tpu/", "perf/", "tools/", "bench.py", "BASELINE",
                 "BENCH_r"):
        assert name not in text, name


def test_names_compared_whole():
    assert loaded_forbidden({"mpi_tpu_torch": 0, "mpi_tpu_torch.ops": 0,
                             "jaxtyping": 0, "flaxen": 0}) == []
    assert loaded_forbidden({"mpi_tpu": 0, "jax.numpy": 0, "flax": 0,
                             "jaxlib.xla": 0, "mpi_tpu.ops.x": 0}) == [
        "flax", "jax.numpy", "jaxlib.xla", "mpi_tpu", "mpi_tpu.ops.x"]


def test_a_run_loads_neither(tmp_path):
    code = (
        "import time, sys\n"
        "from portbench import harness\n"
        "from portbench.run import loaded_forbidden\n"
        "from portbench.tests.small import SMALL, with_waiting\n"
        "m = with_waiting(harness.load_manifest())\n"
        "for cell in [c['name'] for c in m['workloads']]:\n"
        "    tr = SMALL[harness.cell_entry(m, cell)['traffic']]\n"
        "    r = harness.run_cell(cell, 3, 0.05, True, t0=time.perf_counter(),"
        " device='cpu', traffic=tr, manifest=m)\n"
        "    assert r['correct'], r\n"
        "print(loaded_forbidden())\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
