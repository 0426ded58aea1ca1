"""Small traffic of each kind, at sizes a CPU test run holds, for the
cells' files by name; and the served cell that waits for a bound
(``life.serve``, PERF.md's open questions), whose load generator, traffic
and readers the tests keep running through :func:`with_waiting`."""

import copy

SMALL = {
    "run": {"kind": "run", "rows": 64, "cols": 64, "density": 0.5,
            "warmup_passes": 2, "timing_passes": 4, "sampled_passes": 2},
    "padded": {"kind": "run", "rows": 64, "cols": 60, "density": 0.5,
               "warmup_passes": 2, "timing_passes": 4, "sampled_passes": 2},
    "serve": {"kind": "serve", "sessions": 4, "rows": 64, "cols": 64,
              "density": 0.5, "generations_per_request": 16, "batch_max": 2,
              "batch_window_ms": 2, "warmup_requests": 6,
              "sampled_sessions": 2},
}

# the served cell's entries, as BENCHMARK.json would hold them (no bound:
# none holds at its spread yet)
WAITING = {
    "workloads": [{"name": "life.serve", "config": "life",
                   "traffic": "serve", "chips": 1}],
    "end_to_end": [
        {"name": "served_cell_updates_per_s", "unit": "cells/s",
         "workloads": ["life.serve"]},
        {"name": "step_p95_ms", "unit": "ms", "workloads": ["life.serve"]}],
    "per_layer": [
        {"name": name, "unit": unit, "workloads": ["life.serve"]}
        for name, unit in (("k1_roofline.serve", "%"),
                           ("idle_share.serve", "%"),
                           ("boards_per_launch.serve", "boards"),
                           ("host_ms_per_round.serve", "ms"))],
}


def with_waiting(manifest: dict) -> dict:
    """``manifest`` with the entries of :data:`WAITING` added (setup_s,
    listing no cells, covers the served cell too)."""
    out = copy.deepcopy(manifest)
    for key, entries in WAITING.items():
        out[key] = out[key] + copy.deepcopy(entries)
    return out
