"""``mpi_tpu_torch.tune``: the cost-card-guided plan autotuner.

The plan knobs (kernel pass depth ``comm_every``, sparse tile ``T``, the
CTA tile of kernels K1, K3 and K2, the serving batch ``B``) ship with
hand-picked defaults; this package searches them with timed probes on the
device, prunes by the kernels' own op counts, blesses winners against the
parity oracle, and keeps them per (device, requested plan signature) in a
JSON cache that ``build_engine(tune=...)`` and the serve layer's
``EngineCache`` path consult, so a tuned plan applies to a one-shot run
and to live sessions alike, with zero extra compiles on a second session.

Application is OPT-IN (a ``tune=`` argument or the serve CLI's
``--tune-cache``): the default build path never reads the cache.

    python -m mpi_tpu_torch.tune --rows 2048 --cols 2048    # on the card
    python -m mpi_tpu_torch.tune --device cpu --rows 64 --cols 64
    python -m mpi_tpu_torch.tune --check                    # staleness gate
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.tune.cache import (
    TuneCache, default_cache_path, platform_fingerprint, tune_key,
)
from mpi_tpu_torch.tune.space import Candidate, candidates
from mpi_tpu_torch.tune.tuner import TuneResult, should_prune, tune_plan

__all__ = [
    "TuneCache", "TuneResult", "Candidate", "candidates",
    "default_cache_path", "platform_fingerprint", "resolve_tuned",
    "should_prune", "tune_key", "tune_plan",
]


def resolve_tuned(config: GolConfig, mesh_shape: Tuple[int, int],
                  tune: Union[TuneCache, str, None], device=None,
                  ) -> Tuple[GolConfig, Optional[dict]]:
    """(possibly-tuned config, applied plan or None): the one seam
    ``build_engine`` calls.  ``tune`` is a :class:`TuneCache`, a cache
    path, or None (untouched); the key names ``device`` (the card when
    None)."""
    if tune is None:
        return config, None
    cache = tune if isinstance(tune, TuneCache) else TuneCache(str(tune))
    return cache.resolve(config, mesh_shape, device=device)
