"""Device memory + engine-cache telemetry.

The question after "where did the time go" is "where did the device
memory go": a leaked spare buffer or an engine-cache blowup shows up as
an out-of-memory error generations later, far from the cause.  This
sampler rides the telemetry ticker (chained on ``TelemetryRecorder.
after_sample``) and, once per tick:

* reads each visible CUDA device's memory through PyTorch's caching
  allocator — ``in_use`` (``allocated_bytes.all.current`` of
  ``torch.cuda.memory_stats``), ``peak`` (``allocated_bytes.all.peak``)
  and ``limit`` (the device's total memory, ``torch.cuda.mem_get_info``)
  — exported as ``mpi_tpu_device_memory_bytes{device,kind}`` and recorded
  into the telemetry ring so the time series can plot the trend;
* records EngineCache / batched-stepper occupancy
  (``mpi_tpu_engine_cache_entries{cache}`` reads the authoritative
  ``OrderedDict`` sizes at scrape time — the no-shadow-counting rule);
* would time one ghost-ring exchange on a multi-device serving mesh into
  ``mpi_tpu_halo_exchange_seconds{mesh}``: the port's engines span one
  device (meshes are ROADMAP queue 1 item 13), so the probe finds no mesh
  and samples nothing, as the reference's does on one device.

Armed-only: constructed by ``Obs.arm_flight`` when telemetry is armed;
unarmed builds register none of these families.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from mpi_tpu_torch.obs.metrics import LATENCY_BUCKETS

__all__ = ["DevMemSampler", "read_device_memory"]


def read_device_memory() -> Dict[Tuple[str, str], float]:
    """``{(device_label, kind): bytes}`` across the visible CUDA devices
    that this process has initialised, kinds ``in_use``, ``peak`` and
    ``limit``; empty off the card (the host has no device allocator)."""
    import torch

    out: Dict[Tuple[str, str], float] = {}
    if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
        return out
    for i in range(torch.cuda.device_count()):
        label = f"cuda:{i}"
        stats = torch.cuda.memory_stats(i)
        for src, kind in (("allocated_bytes.all.current", "in_use"),
                          ("allocated_bytes.all.peak", "peak")):
            if src in stats:
                out[(label, kind)] = float(stats[src])
        out[(label, "limit")] = float(torch.cuda.mem_get_info(i)[1])
    return out


class DevMemSampler:
    """One tick of device-memory + cache telemetry.

    ``sample(now)`` is chained after the SLO evaluation on the telemetry
    ticker; a raising backend must not kill the sampler (errors are
    counted, the tick survives).  The memory snapshot is held for the
    scrape callbacks.
    """

    def __init__(self, obs, manager=None, halo_probe: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self._manager = manager
        self._halo_enabled = halo_probe
        self._clock = clock
        self._lock = threading.Lock()
        self._mem: Dict[Tuple[str, str], float] = {}
        self._samples = 0
        self._errors = 0
        self.halo_hist = obs.metrics.histogram(
            "mpi_tpu_halo_exchange_seconds",
            "Wall time of one probed ghost-ring exchange on the serving "
            "mesh (armed only: --flight-recorder + telemetry)",
            LATENCY_BUCKETS)

    # -- sampling --------------------------------------------------------

    def sample(self, now: Optional[float] = None) -> None:
        try:
            mem = read_device_memory()
            with self._lock:
                self._mem = mem
                self._samples += 1
        except Exception:  # noqa: BLE001 — the ticker must outlive a driver error
            with self._lock:
                self._errors += 1

    def memory_total(self, kind: str = "in_use") -> float:
        """Summed bytes across devices for one kind — the telemetry-ring
        series feed."""
        with self._lock:
            mem = dict(self._mem)
        return sum(v for (_, k), v in mem.items() if k == kind)

    # -- readouts --------------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            return {"samples": self._samples, "errors": self._errors,
                    "devices": len({d for d, _ in self._mem}),
                    "halo_probe": self._halo_enabled}

    # -- armed-only registry families ------------------------------------

    def bind_metrics(self, m) -> None:
        def _mem_series():
            with self._lock:
                mem = dict(self._mem)
            return [({"device": dev, "kind": kind}, v)
                    for (dev, kind), v in sorted(mem.items())]

        m.gauge_fn("mpi_tpu_device_memory_bytes",
                   "Per-device memory by kind (in_use/limit/peak from "
                   "the allocator, live_arrays on backends without "
                   "stats)",
                   _mem_series)

        def _cache_entries():
            mgr = self._manager
            if mgr is None:
                return []
            st = mgr.cache.stats()
            return [({"cache": "engine"}, st["size"]),
                    ({"cache": "batched"}, st["batched"]["size"])]

        m.gauge_fn("mpi_tpu_engine_cache_entries",
                   "Compiled-engine, batched-stepper, and tune-cache "
                   "occupancy (authoritative sizes read at scrape time)",
                   _cache_entries)
