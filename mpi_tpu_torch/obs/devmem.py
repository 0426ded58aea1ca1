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
* times one ghost-ring exchange on the serving mesh (the first live
  engine on more than one shard) into
  ``mpi_tpu_halo_exchange_seconds{mesh}``: ``parallel/step.py:
  make_halo_probe`` on a ``HALO_PROBE_TILE``-square uint8 tile a shard,
  warmed once outside the timed window.  On the card the sample is the
  probe's own device time, between two CUDA events on each card's current
  stream (the longest card's), so serving rounds queued ahead of it on
  that card do not count; on the host, where every exchange is
  synchronous, it is the call's wall time.  With every session on one
  device the probe finds no mesh and samples nothing, as the reference's
  does.  The family's help text is the reference's, word for word.

Armed-only: constructed by ``Obs.arm_flight`` when telemetry is armed;
unarmed builds register none of these families.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

from mpi_tpu_torch.obs.metrics import LATENCY_BUCKETS

__all__ = ["DevMemSampler", "HALO_PROBE_TILE", "read_device_memory",
           "time_probe"]

# side of the square uint8 tile a shard that the halo probe exchanges
HALO_PROBE_TILE = 128


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


def time_probe(fn: Callable, operand, devices) -> float:
    """Seconds that ``fn(operand)`` itself takes.  On the card: the device
    time between two CUDA events recorded on each of ``devices``' current
    streams around the call, the longest card's; work queued on a card
    before the call (a serving round) runs before the first event and is
    not counted.  With no card among ``devices``: the call's wall time,
    every host op being synchronous."""
    import torch

    cards = sorted({d for d in devices if d.type == "cuda"}, key=str)
    if not cards:
        t0 = time.perf_counter()
        fn(operand)
        return time.perf_counter() - t0
    marks = []
    for dev in cards:
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(dev))
        marks.append((dev, start))
    fn(operand)
    spans = []
    for dev, start in marks:
        end = torch.cuda.Event(enable_timing=True)
        end.record(torch.cuda.current_stream(dev))
        end.synchronize()
        spans.append(start.elapsed_time(end) / 1e3)
    return max(spans)


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
        # the memoized probe: (mesh key) -> (probe, operand, its series)
        self._probe_key = None
        self._probe = None
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
            return
        if self._halo_enabled:
            try:
                self._probe_halo()
            except Exception:  # noqa: BLE001 — a probe must not kill the tick
                with self._lock:
                    self._errors += 1

    def memory_total(self, kind: str = "in_use") -> float:
        """Summed bytes across devices for one kind — the telemetry-ring
        series feed."""
        with self._lock:
            mem = dict(self._mem)
        return sum(v for (_, k), v in mem.items() if k == kind)

    # -- halo probe ------------------------------------------------------

    def _serving_mesh(self):
        """(mesh, boundary) of the first live engine on more than one shard
        of one process, or (None, None): a one-device engine exchanges with
        itself, nothing worth timing."""
        mgr = self._manager
        if mgr is None:
            return None, None
        from mpi_tpu_torch.obs.profile import _live_engines

        for e in _live_engines(mgr):
            mesh = getattr(e, "mesh", None)
            if mesh is not None and mesh.size > 1 and not mesh.multiprocess:
                return mesh, getattr(e.config, "boundary", "periodic")
        return None, None

    def _probe_halo(self) -> None:
        mesh, boundary = self._serving_mesh()
        if mesh is None:
            return
        import torch

        from mpi_tpu_torch.parallel.mesh import AXES
        from mpi_tpu_torch.parallel.step import make_halo_probe

        key = (mesh.dims, boundary,
               tuple(str(d) for row in mesh.devices for d in row))
        if key != self._probe_key:
            n = HALO_PROBE_TILE
            operand = [[torch.zeros((n, n), dtype=torch.uint8, device=d)
                        for d in row] for row in mesh.devices]
            fn = make_halo_probe(mesh, boundary)
            # warmed outside the timed window: the first exchange pays the
            # allocator's first blocks, not the halo's time
            time_probe(fn, operand, mesh.local_devices())
            label = "x".join(str(mesh.shape[a]) for a in AXES)
            self._probe_key = key
            self._probe = (fn, operand, self.halo_hist.series(mesh=label))
        fn, operand, series = self._probe
        series.observe(time_probe(fn, operand, mesh.local_devices()))

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
            out = [({"cache": "engine"}, st["size"]),
                   ({"cache": "batched"}, st["batched"]["size"])]
            tc = getattr(mgr, "tune_cache", None)
            if tc is not None:
                out.append(({"cache": "tune"}, len(tc)))
            return out

        m.gauge_fn("mpi_tpu_engine_cache_entries",
                   "Compiled-engine, batched-stepper, and tune-cache "
                   "occupancy (authoritative sizes read at scrape time)",
                   _cache_entries)
