"""One run of one cell: find what ``BENCHMARK.json`` names by name, drive
the cell's traffic, read its metrics and assemble the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name:

* ``configs/<config>.json``, the file the manifest's ``configs`` entry
  names (the rule, the boundary, ``comm_every``);
* ``traffic/<traffic>.json``, whose ``kind`` picks the load
  generator ``kinds/<kind>.py`` and whose other keys are its
  parameters;
* ``metrics/<metric>.py``, a reader ``read(trace, work)`` that returns the
  metric, or None where its run holds nothing for it.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import subprocess
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from portbench import roofline
from portbench.devtrace import Capture
from portbench.reference.cells import Rule, parse_rule

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_manifest() -> dict:
    return json.loads(MANIFEST.read_text())


def cell_entry(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in the manifest; it has "
                   f"{[c['name'] for c in manifest['workloads']]}")


def config_file(manifest: dict, name: str) -> dict:
    for cfg in manifest["configs"]:
        if cfg["name"] == name:
            return json.loads((ROOT / cfg["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in the manifest")


def traffic_file(name: str) -> dict:
    return json.loads((PACKAGE / "traffic" / f"{name}.json").read_text())


def end_to_end(manifest: dict, cell: str) -> list:
    """The end-to-end metrics cell ``cell`` reports."""
    return [m for m in manifest["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(manifest: dict, cell: str) -> list:
    """The per-layer metrics cell ``cell`` reports: those whose
    ``workloads`` list it."""
    return [m for m in manifest["per_layer"] if cell in m["workloads"]]


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = PACKAGE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Context:
    """What a traffic kind gets: the cell's configuration and traffic, the
    parsed rule, the run's arguments, where it runs, the process's start
    time (set-up is counted from it) and the profiler's capture.

    A kind makes its inputs and the buffers of its check first, then
    calls :meth:`program_start`; the memory peak is counted from there,
    less what the harness then holds, so it is the program's alone."""

    config: dict
    traffic: dict
    rule: Rule
    seed: int
    seconds: float
    device: str
    t0: float
    capture: Capture
    marks: dict
    harness_bytes: int = 0

    def program_start(self) -> None:
        """Mark where the program's memory begins: what the card holds now
        is the harness's inputs and check buffers, held to the end."""
        import torch

        if self.device != "cuda":
            return
        torch.cuda.synchronize()
        self.harness_bytes = int(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()

    def memory_peak(self) -> int:
        """Bytes at the program's allocation peak since
        :meth:`program_start` (0 on the CPU)."""
        import torch

        if self.device != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated()) - self.harness_bytes

    def free(self) -> None:
        """Hand the memory of what the caller dropped back to the card."""
        import torch

        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()


# what nvidia-smi reads of the card after a run, and in the middle of a
# window that keeps the card busy (a host-bound window is left undisturbed)
CARD = {"power.limit": "power_limit_w", "clocks.max.sm": "sm_clock_max_mhz"}
CARD_UNDER_LOAD = {"clocks.sm": "sm_clock_window_mhz",
                   "power.draw": "power_draw_window_w",
                   "temperature.gpu": "temperature_window_c"}


def card_readings(keys: dict = CARD, index: int = 0) -> dict:
    """The card's readings that ``keys`` names (nvidia-smi's query name
    to the name returned), as ``nvidia-smi`` reads them (empty where it
    cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", f"--query-gpu={','.join(keys)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return {}
    vals = [v.strip() for v in out.stdout.strip().split(",")]
    read = {}
    for name, v in zip(keys.values(), vals):
        try:
            read[name] = float(v)
        except ValueError:
            continue
    return read


class MidWindow:
    """Reads the card under load once, ``delay`` seconds after
    :meth:`start`, on a thread of its own; nothing off the card."""

    def __init__(self, ctx, delay: float):
        self.readings = {}
        self._thread = None
        if ctx.device == "cuda":
            self._thread = threading.Timer(delay, self._read)
            self._thread.daemon = True

    def _read(self) -> None:
        self.readings = card_readings(CARD_UNDER_LOAD)

    def start(self) -> None:
        if self._thread is not None:
            self._thread.start()

    def result(self) -> dict:
        """The readings, once the thread has ended (cancelled if it has
        not begun)."""
        if self._thread is not None:
            self._thread.cancel()
            self._thread.join()
        return self.readings


def run_cell(name: str, seed: int, seconds: float, trace: bool, t0: float,
             device: str = "cuda", traffic: Optional[dict] = None,
             manifest: Optional[dict] = None,
             marks: Optional[dict] = None) -> dict:
    """Run cell ``name`` once and return its result line as a dict, the
    numbers it compared last under ``checks``.  ``traffic`` replaces the
    cell's traffic file (the tests' small boards); ``marks`` are the ends
    of the caller's phases of set-up, in seconds from ``t0``."""
    import torch

    manifest = manifest or load_manifest()
    cell = cell_entry(manifest, name)
    config = config_file(manifest, cell["config"])
    traffic = traffic or traffic_file(cell["traffic"])
    cuda = device == "cuda"
    ctx = Context(config=config, traffic=traffic,
                  rule=parse_rule(config["rule"]), seed=seed,
                  seconds=seconds, device=device, t0=t0,
                  capture=Capture(trace, cuda), marks=dict(marks or {}))
    kind = importlib.import_module(f"portbench.kinds.{traffic['kind']}")
    out = kind.run(ctx)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell["chips"], "memory_peak_bytes": out.memory_peak_bytes}
    if cuda:
        dev.update(card_readings())
        dev.update(out.under_load)
    metrics = {}
    result = {"correct": all(v <= lim for _, v, lim in out.checks),
              "attempted": out.attempted, "failed": out.failed,
              "metrics": metrics, "device": dev}
    if not trace:
        for m in end_to_end(manifest, name):
            metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                  "unit": m["unit"]}
    else:
        t = out.trace
        if cuda and t.busy_s <= 0:
            raise RuntimeError("the profiler recorded no device operation "
                               "in the window")
        work = dict(out.work)
        if cuda:
            work["int32_ops_per_s"] = roofline.int32_ops_per_s()
            work["hbm_bytes_per_s"] = roofline.HBM_BYTES_PER_S
        for m in per_layer(manifest, name):
            v = reader(m["name"])(t, work)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = t.breakdown()
    result["seconds"] = {"window": out.window_s, "check": out.check_s,
                         "setup": out.setup_phases}
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out.checks}
    return result
