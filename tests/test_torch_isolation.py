"""The port stands alone: no module of ``mpi_tpu_torch`` (its ``obs``
package and native backends included) and not ``chip_smoke.py`` imports
JAX or anything of the JAX package ``mpi_tpu``, and no file of the port
names the reference's native build directory."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(os.path.join(ROOT, "mpi_tpu_torch")):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_import(path):
    roots = set(_imported_roots(path))
    assert not roots & {"jax", "jaxlib", "mpi_tpu"}, roots


def test_cpu_slice_runs_without_loading_jax(tmp_path):
    code = (
        "import sys\n"
        "from mpi_tpu_torch.cli import main\n"
        "from mpi_tpu_torch.backends.cuda import run_cuda\n"
        "from mpi_tpu_torch.config import GolConfig\n"
        "import mpi_tpu_torch.interop, mpi_tpu_torch.ops._build\n"
        "import mpi_tpu_torch.ops.cuda_bitltl, mpi_tpu_torch.ops.cuda_stencil\n"
        "import mpi_tpu_torch.parallel.seam, mpi_tpu_torch.parallel.policy\n"
        "import mpi_tpu_torch.ops.activity\n"
        "from mpi_tpu_torch.backends.cuda import build_engine\n"
        "from mpi_tpu_torch.models.rules import BOSCO\n"
        "for kw in (dict(cols=64, comm_every=2), dict(cols=64, rule=BOSCO),"
        " dict(cols=50, rule=BOSCO, comm_every=2), dict(cols=50),"
        " dict(cols=50, boundary='dead', rule=BOSCO),"
        " dict(rows=32, cols=64, rule=BOSCO, comm_every=4),"
        " dict(cols=48, sparse_tile=16, rule=BOSCO),"
        " dict(rows=32, cols=64, sparse_tile=32)):\n"
        "    run_cuda(GolConfig(**{'rows': 16, 'steps': 5, **kw}),"
        " device='cpu')\n"
        "eng = build_engine(GolConfig(rows=16, cols=50, steps=0), 'cpu')\n"
        "eng.step_batched(eng.init_grids(seeds=[1, 2]), 3)\n"
        f"assert main(['16', '64', '2', '4', '--save', '--device', 'cpu',"
        f" '--quiet', '--out-dir', {str(tmp_path)!r}]) == 0\n"
        f"assert main(['32', '64', '2', '4', '--sparse', '32', '--device',"
        f" 'cpu', '--quiet', '--out-dir', {str(tmp_path)!r}]) == 0\n"
        f"assert main(['16', '50', '2', '4', '--comm-every', 'auto',"
        f" '--device', 'cpu', '--quiet', '--out-dir', {str(tmp_path)!r}]) == 0\n"
        "from mpi_tpu_torch.serve import SessionManager\n"
        f"mgr = SessionManager(device='cpu', state_dir={str(tmp_path)!r})\n"
        "sid = mgr.create({'rows': 16, 'cols': 64, 'seed': 3})['id']\n"
        "assert mgr.step(sid, 3)['generation'] == 3\n"
        "t = mgr.step_async(sid, 2)['ticket']\n"
        "assert mgr.ticket_result(t, wait=True)['result']['generation'] == 5\n"
        "mgr.shutdown()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def _native_files():
    d = os.path.join(ROOT, "mpi_tpu_torch", "backends", "native")
    return sorted(os.path.join(d, f) for f in ("golcore.cpp", "gol_main.cpp",
                                               "Makefile"))


# the reference's built native files live in mpi_tpu/backends/native: a
# path to them, however joined, is "mpi_tpu" then "backends" then "native"
_REF_NATIVE = re.compile(
    r"""mpi_tpu(?!_torch)["'/\\, ]+(os\.sep[, ]+)?backends["'/\\, ]+native""")


@pytest.mark.parametrize("path", _port_files() + _native_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_port_file_names_the_reference_native_dir(path):
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    assert not _REF_NATIVE.search(text), path


def test_the_pattern_finds_the_reference_native_dir():
    for text in ('os.path.join(ROOT, "mpi_tpu", "backends", "native")',
                 "mpi_tpu/backends/native/libgolcore.so"):
        assert _REF_NATIVE.search(text)
    assert not _REF_NATIVE.search("mpi_tpu_torch/backends/native")


def test_native_and_obs_run_without_loading_jax(tmp_path):
    code = (
        "import sys\n"
        "import mpi_tpu_torch.obs as o\n"
        "import mpi_tpu_torch.obs.anomaly, mpi_tpu_torch.obs.cost\n"
        "import mpi_tpu_torch.obs.devmem, mpi_tpu_torch.obs.flight\n"
        "import mpi_tpu_torch.obs.ledger, mpi_tpu_torch.obs.metrics\n"
        "import mpi_tpu_torch.obs.profile, mpi_tpu_torch.obs.slo\n"
        "import mpi_tpu_torch.obs.timeseries, mpi_tpu_torch.parallel.mesh\n"
        "from mpi_tpu_torch.backends import cpp\n"
        "from mpi_tpu_torch.backends.serial_np import run_serial\n"
        "from mpi_tpu_torch.cli import main\n"
        "from mpi_tpu_torch.config import GolConfig\n"
        "from mpi_tpu_torch.serve import SessionManager\n"
        "run_serial(GolConfig(rows=16, cols=16, steps=3, backend='serial'))\n"
        f"for b in (['cpp'], ['cpp-par', '--workers', '4']):\n"
        f"    assert main(['32', '32', '2', '4', '--save', '--quiet',"
        f" '--out-dir', {str(tmp_path)!r}, '--backend', *b]) == 0\n"
        "obs = o.Obs()\n"
        "mgr = SessionManager(device='cpu', obs=obs)\n"
        "obs.arm_telemetry(manager=mgr, start=False)\n"
        "obs.arm_flight(manager=mgr, anomaly=True)\n"
        "a = mgr.create({'rows': 16, 'cols': 64, 'seed': 3})['id']\n"
        "b = mgr.create({'rows': 16, 'cols': 64, 'backend': 'cpp-par'})['id']\n"
        "for sid in (a, b):\n"
        "    assert mgr.step(sid, 3)['generation'] == 3\n"
        "obs.telemetry.sample_once()\n"
        "mgr.usage(); mgr.stats(); mgr.slo(); obs.render_metrics()\n"
        "mgr.shutdown()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
