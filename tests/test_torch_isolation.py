"""The port stands alone: no module of ``mpi_tpu_torch`` (its ``obs``,
``admission``, ``serve``, ``cluster`` and ``tune`` packages, network
fronts and native backends included) and not ``chip_smoke.py`` imports JAX or
anything of the JAX package ``mpi_tpu``, no file of the port names the
reference's native build directory, and the slices run, the network front
served by its CLI and a cluster pair among them, with neither loaded."""

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


def test_the_scan_covers_the_tuner():
    """``tune/`` is scanned like every other package of the port."""
    tuner = {os.path.relpath(p, ROOT) for p in _port_files()
             if os.sep + "tune" + os.sep in p}
    assert tuner == {os.path.join("mpi_tpu_torch", "tune", f) for f in (
        "__init__.py", "__main__.py", "cache.py", "space.py", "tuner.py")}


def test_tuner_and_profile_run_without_loading_jax(tmp_path):
    """``python -m mpi_tpu_torch.tune`` (tune, ``--check``), a tuned
    session, ``cli.py --profile`` and golio's readers on the CPU, with
    neither JAX nor ``mpi_tpu`` loaded."""
    cache = str(tmp_path / "tc.json")
    code = (
        "import sys\n"
        "from mpi_tpu_torch import golio\n"
        "from mpi_tpu_torch.cli import main\n"
        "from mpi_tpu_torch.tune.__main__ import main as tune\n"
        f"assert tune(['--device', 'cpu', '--rows', '32', '--cols', '64',"
        f" '--steps', '2', '--reps', '1', '--quiet', '--cache',"
        f" {cache!r}]) == 0\n"
        f"assert tune(['--check', '--cache', {cache!r}]) == 0\n"
        "from mpi_tpu_torch.serve import SessionManager\n"
        f"mgr = SessionManager(device='cpu', tune_cache={cache!r})\n"
        "assert mgr.step(mgr.create({'rows': 32, 'cols': 64})['id'], 2)\n"
        "mgr.shutdown()\n"
        f"assert main(['16', '64', '2', '4', '--save', '--device', 'cpu',"
        f" '--quiet', '--name', 'p', '--out-dir', {str(tmp_path)!r},"
        f" '--profile', {str(tmp_path / 'trace')!r}]) == 0\n"
        f"its = golio.list_snapshot_iterations({str(tmp_path)!r}, 'p')\n"
        f"golio.assemble_region({str(tmp_path)!r}, 'p', its[-1], 0, 8, 0, 8)\n"
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


def test_network_front_serves_without_loading_jax(tmp_path):
    """``python -m mpi_tpu_torch.cli serve --device cpu`` (run as
    ``__main__`` in a thread of a subprocess, on the aio front with
    admission, telemetry and the flight recorder armed) serves a few
    requests with neither JAX nor ``mpi_tpu`` loaded."""
    code = (
        "import http.client, json, runpy, sys, threading\n"
        "import mpi_tpu_torch.serve.aio as aio\n"
        "made = []\n"
        "real = aio.make_aio_server\n"
        "def spy(*a, **kw):\n"
        "    made.append(real(*a, **kw))\n"
        "    return made[-1]\n"
        "aio.make_aio_server = spy\n"
        "sys.argv = ['mpi_tpu_torch.cli', 'serve', '--port', '0',"
        " '--device', 'cpu', '--front', 'aio', '--admission',"
        " '--telemetry-interval-s', '60', '--flight-recorder',"
        f" '--state-dir', {str(tmp_path)!r}]\n"
        "def run():\n"
        "    try:\n"
        "        runpy.run_module('mpi_tpu_torch.cli', run_name='__main__')\n"
        "    except SystemExit:\n"
        "        pass\n"
        "t = threading.Thread(target=run, daemon=True)\n"
        "t.start()\n"
        "import time\n"
        "deadline = time.monotonic() + 120\n"
        "while not made and time.monotonic() < deadline:\n"
        "    t.join(0.05)\n"
        "srv = made[0]\n"
        "c = http.client.HTTPConnection(*srv.server_address[:2], timeout=60)\n"
        "def rt(m, p, b=None):\n"
        "    c.request(m, p, body=None if b is None else json.dumps(b))\n"
        "    r = c.getresponse()\n"
        "    return r.status, r.read()\n"
        "st, body = rt('POST', '/sessions', {'rows': 16, 'cols': 64})\n"
        "assert st == 200, body\n"
        "sid = json.loads(body)['id']\n"
        "assert rt('POST', f'/sessions/{sid}/step', {'steps': 3})[0] == 200\n"
        "st, body = rt('POST', f'/sessions/{sid}/step?async=1', {'steps': 2})\n"
        "tid = json.loads(body)['ticket']\n"
        "st, body = rt('GET', f'/result/{tid}?wait=1')\n"
        "assert json.loads(body)['result']['generation'] == 5, body\n"
        "for p in ('/metrics', '/usage', '/slo', '/debug/flights'):\n"
        "    assert rt('GET', p)[0] == 200, p\n"
        "c.close()\n"
        "srv.shutdown()\n"
        "t.join(60)\n"
        "assert not t.is_alive()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


def test_cluster_files_are_scanned():
    scanned = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in ("__init__", "gossip", "node", "proxy", "ring"):
        assert os.path.join("mpi_tpu_torch", "cluster",
                            f"{name}.py") in scanned


def test_cluster_pair_serves_without_loading_jax(tmp_path):
    """Two port servers joined as a cluster over one state dir: a create
    placed on the peer, a proxied step and snapshot, a gossip round, a
    drain and the offline scrub, with neither JAX nor ``mpi_tpu``
    loaded."""
    code = (
        "import http.client, json, sys, threading\n"
        "from mpi_tpu_torch.cluster import ClusterNode\n"
        "from mpi_tpu_torch.serve import SessionManager\n"
        "from mpi_tpu_torch.serve.httpd import make_server\n"
        "from mpi_tpu_torch.serve.recovery import scan_state_dir\n"
        f"state = {str(tmp_path)!r}\n"
        "nodes = []\n"
        "for _ in range(2):\n"
        "    mgr = SessionManager(device='cpu', state_dir=state,"
        " batching=False, defer_restore=True)\n"
        "    srv = make_server('127.0.0.1', 0, mgr)\n"
        "    threading.Thread(target=srv.serve_forever, daemon=True).start()\n"
        "    nodes.append((mgr, srv, '%s:%d' % srv.server_address[:2]))\n"
        "for i, (mgr, srv, addr) in enumerate(nodes):\n"
        "    node = ClusterNode(addr, [nodes[1 - i][2]], mgr,"
        " interval_s=3600.0, state_dir=state)\n"
        "    mgr.attach_cluster(node)\n"
        "    srv.core.cluster = node\n"
        "def rt(addr, m, p, b=None):\n"
        "    c = http.client.HTTPConnection(*addr.split(':'), timeout=60)\n"
        "    c.request(m, p, body=None if b is None else json.dumps(b))\n"
        "    r = c.getresponse()\n"
        "    out = r.status, r.read()\n"
        "    c.close()\n"
        "    return out\n"
        "a, b = nodes[0][2], nodes[1][2]\n"
        "sids = [json.loads(rt(a, 'POST', '/sessions',"
        " {'rows': 16, 'cols': 64, 'seed': s})[1])['id'] for s in range(6)]\n"
        "assert set(nodes[0][0].session_ids()) | set(nodes[1][0].session_ids())"
        " == set(sids)\n"
        "for sid in sids:\n"
        "    st, body = rt(b, 'POST', f'/sessions/{sid}/step', {'steps': 3})\n"
        "    assert st == 200 and json.loads(body)['generation'] == 3, body\n"
        "nodes[0][1].core.cluster.gossip_now()\n"
        "st, body = rt(a, 'POST', '/cluster/drain')\n"
        "assert st == 200 and json.loads(body)['ok'], body\n"
        "assert not nodes[0][0].session_ids()\n"
        "assert sorted(nodes[1][0].session_ids()) == sorted(sids)\n"
        "assert scan_state_dir(state)['clean']\n"
        "for mgr, srv, _ in nodes:\n"
        "    srv.shutdown()\n"
        "    srv.server_close()\n"
        "    mgr.shutdown()\n"
        "bad = [m for m in sys.modules"
        " if m.split('.')[0] in ('jax', 'jaxlib', 'mpi_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
