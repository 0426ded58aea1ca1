"""K-generation segmentation of an evolution: ``steps // K`` passes of K
generations plus one remainder pass, as ``mpi_tpu.utils.segmenting`` plans
them, run as a Python loop over kernel launches."""

from __future__ import annotations


def segmented_evolve(local, K: int, obs=None):
    """evolve(grid, steps, spare) -> (grid, spare).

    ``local(src, k, dst)`` advances ``src`` by ``k`` generations into
    ``dst`` and returns it.  The two buffers ping-pong: each pass writes
    into the buffer the pass before it read, so ``grid`` is consumed and
    comes back as the new spare.  The caller must not read a buffer it has
    handed over: the next pass overwrites it.  Launches queue on one stream
    in order, so a pass never overwrites a buffer an earlier pass still
    reads.

    ``obs``: the zero-argument getter of an ``mpi_tpu_torch.obs.Obs``
    handle (an engine's, set after the stepper is built); while it gives
    one, each pass runs inside an ``engine.pass`` span (fields ``depth``,
    and ``boards`` for a stacked batch) around everything the pass
    launches."""
    if obs is not None:
        local = _traced(local, obs)

    def evolve(grid, steps: int, spare):
        k = max(1, min(K, steps))
        full, rem = divmod(steps, k)
        for _ in range(full):
            grid, spare = local(grid, k, spare), grid
        if rem:
            grid, spare = local(grid, rem, spare), grid
        return grid, spare

    return evolve


def _traced(local, obs):
    """``local`` inside an ``engine.pass`` span while ``obs()`` gives a
    handle, and ``local`` itself (one ``is None`` test) while it gives
    None."""

    def run(src, k, dst):
        handle = obs()
        if handle is None:
            return local(src, k, dst)
        if src.dim() == 3:
            span = handle.span("engine.pass", depth=k, boards=src.shape[0])
        else:
            span = handle.span("engine.pass", depth=k)
        with span:
            return local(src, k, dst)

    return run


def segment_depths(segments, K: int):
    """The pass depths ``segmented_evolve`` runs for these segment lengths:
    each segment n runs ⌊n/k⌋ passes of depth k = min(K, n) plus one
    remainder pass of depth n % k."""
    depths = set()
    for n in set(segments):
        if n <= 0:
            continue
        k = max(1, min(K, n))
        depths.add(k)
        if n % k:
            depths.add(n % k)
    return depths
