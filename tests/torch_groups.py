"""Process groups of the port's CLI for the tests: ``python -m
mpi_tpu_torch.cli ... --device cpu --multihost --coordinator
127.0.0.1:PORT`` in N processes on gloo, and the reference's run of the
same config in this process on its 8 virtual CPU devices (``--mesh
IxJ``), the yardstick the group's files are held to byte for byte."""

from __future__ import annotations

import filecmp
import os
import subprocess
import sys
import tempfile
import time

from mpi_tpu.cli import main as jax_main
from mpi_tpu.utils.net import PORT_RETRIES, bind_collision, free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 120.0


def launch(argv, n, out_dirs, timeout_s=GROUP_TIMEOUT_S):
    """Start ``n`` ranks of the CLI with ``argv`` (rank p writes into
    ``out_dirs[p]``, or all into one dir) and wait for all of them;
    returns [(returncode, stdout, stderr)] by rank.  A group that outlasts
    ``timeout_s`` is killed, every rank, and raises.  The free-port probe
    races other processes for the port: when the coordinator's bind lost
    it (its rank exits at once, the others would wait for a store that is
    not theirs), the group is killed and starts again on a fresh port."""
    if isinstance(out_dirs, str):
        out_dirs = [out_dirs] * n
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    for attempt in range(PORT_RETRIES):
        port = free_port("127.0.0.1")
        logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
                for _ in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "mpi_tpu_torch.cli", *argv,
             "--device", "cpu", "--multihost", "--coordinator",
             f"127.0.0.1:{port}", "--num-processes", str(n),
             "--process-id", str(p), "--out-dir", out_dirs[p]],
            env=env, cwd=REPO, stdout=out, stderr=err, text=True)
            for p, (out, err) in enumerate(logs)]

        def stderr(p):
            logs[p][1].seek(0)
            return logs[p][1].read()

        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in procs):
                collided = any(p.returncode not in (None, 0)
                               and bind_collision(stderr(i))
                               for i, p in enumerate(procs))
                if collided and attempt + 1 < PORT_RETRIES:
                    break
                if time.monotonic() > deadline:
                    raise subprocess.TimeoutExpired(argv, timeout_s)
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for i, (p, (out, err)) in enumerate(zip(procs, logs)):
            out.seek(0)
            results.append((p.returncode, out.read(), stderr(i)))
            out.close()
            err.close()
        if attempt + 1 < PORT_RETRIES and any(
                rc != 0 and bind_collision(e) for rc, _, e in results):
            continue
        return results


def run_group(argv, n, out_dir):
    """:func:`launch` that every rank must pass; returns each rank's
    stdout."""
    results = launch(argv, n, out_dir)
    for p, (rc, out, err) in enumerate(results):
        assert rc == 0, f"rank {p} exited {rc}:\n{out}\n{err[-3000:]}"
    return [out for _, out, _ in results]


def reference(argv, mesh, name, out_dir):
    """The reference CLI's single-process run of ``argv`` on ``mesh`` of
    its virtual CPU devices, named ``name``."""
    assert jax_main(list(argv) + ["--backend", "tpu", "--mesh", mesh,
                                  "--name", name, "--out-dir", out_dir,
                                  "--quiet"]) == 0


def snapshot_files(d):
    return sorted(f for f in os.listdir(d) if f.endswith((".gol", ".golp")))


def assert_same_files(ref_dir, port_dir):
    """The master header and every tile file, byte for byte."""
    names = snapshot_files(ref_dir)
    assert names and names == snapshot_files(port_dir)
    for f in names:
        assert filecmp.cmp(os.path.join(ref_dir, f),
                           os.path.join(port_dir, f), shallow=False), f
