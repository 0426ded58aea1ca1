"""The JSON tune cache: persisted autotuner winners keyed by plan.

One entry per (platform fingerprint, requested plan signature): the
*requested* signature, not the winner's, so a user who asks for
``comm_every=4`` has another key than one who took the defaults and an
explicit choice is never overridden.  The key drops the signature's
``segments`` field (the snapshot cadence changes which depths are warmed,
not which plan wins) and writes the rule in its parseable canonical form
(``B3/S23`` / ``R2,B8-12,S9-14``), so equal rules share one winner
whatever their names.

Entries store a reconstructable ``base`` config dict, the winning
``plan`` override dict (``{}``: the default plan won, still worth keeping:
the next run knows tuning already happened) and the measured A/B stats.
The file is advisory state, never load-bearing: a corrupt or missing file
reads as an empty cache, and a stale plan that no longer validates under
the current :mod:`mpi_tpu_torch.config` rules (or a CTA tile the kernel no
longer takes) is skipped at resolve time and reported by ``python -m
mpi_tpu_torch.tune --check``.

The key embeds ``len(SIGNATURE_FIELDS)`` as a schema version, so
extending the plan signature orphans every cached winner instead of
mis-applying it.  The fingerprint names the device (``cuda:<name>:<count>``
or ``cpu:cpu:1``), so a winner found on the CPU never applies on the card
and the reverse, and the file (``perf/tune_cache_torch.json``) is not the
JAX package's.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
from typing import Dict, List, Optional, Tuple

from mpi_tpu_torch.config import (
    ConfigError, GolConfig, SIGNATURE_FIELDS, apply_plan, validate_mesh,
    validate_size,
)
from mpi_tpu_torch.models.rules import Rule, _intervals, rule_from_name

FORMAT_VERSION = 1


def default_cache_path() -> str:
    """``perf/tune_cache_torch.json`` at the root of the checkout, unless
    ``MPI_TPU_TUNE_CACHE`` points elsewhere."""
    env = os.environ.get("MPI_TPU_TUNE_CACHE")
    if env:
        return env
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(root, "perf", "tune_cache_torch.json")


def platform_fingerprint(device) -> str:
    """``platform:device_kind:count`` of the device a plan runs on, the
    hardware half of the tune key: ``cuda:<device name, spaces as
    _>:<device count>`` for the card (``device`` None or a CUDA device),
    ``cpu:cpu:1`` for ``"cpu"``."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return "cpu:cpu:1"
    name = torch.cuda.get_device_name(dev).replace(" ", "_")
    return f"cuda:{name}:{torch.cuda.device_count()}"


def rule_canonical(rule: Rule) -> str:
    """A canonical rule string ``rule_from_name`` reparses, without the
    rule's name (``life`` and ``B3/S23`` share one winner)."""
    if rule.radius == 1:
        b = "".join(str(c) for c in sorted(rule.birth))
        s = "".join(str(c) for c in sorted(rule.survive))
        return f"B{b}/S{s}"

    def ranges(counts) -> str:
        return "+".join(f"{lo}-{hi}" if lo != hi else str(lo)
                        for lo, hi in _intervals(counts))

    return (f"R{rule.radius},B{ranges(rule.birth)},"
            f"S{ranges(rule.survive)}")


def base_dict(config: GolConfig, mesh_shape: Tuple[int, int]) -> dict:
    """The reconstructable request-plan fields of one entry: the
    signature without ``segments``, the rule canonical."""
    return {
        "rows": config.rows,
        "cols": config.cols,
        "rule": rule_canonical(config.rule),
        "boundary": config.boundary,
        "backend": config.backend,
        "mesh": [int(mesh_shape[0]), int(mesh_shape[1])],
        "comm_every": config.comm_every,
        "overlap": bool(config.overlap),
        "sparse_tile": config.sparse_tile,
    }


def config_from_base(base: dict) -> Tuple[GolConfig, Tuple[int, int]]:
    """Rebuild (config, mesh_shape) from an entry's ``base`` dict, under
    every current validation rule (the ``--check`` path)."""
    mesh = tuple(int(x) for x in base["mesh"])
    cfg = GolConfig(
        rows=int(base["rows"]), cols=int(base["cols"]), steps=0,
        rule=rule_from_name(str(base["rule"])),
        boundary=str(base["boundary"]), backend=str(base["backend"]),
        mesh_shape=mesh, comm_every=int(base.get("comm_every", 1)),
        overlap=bool(base.get("overlap", False)),
        sparse_tile=int(base.get("sparse_tile", 0)),
    )
    return cfg, mesh


def tune_key(config: GolConfig, mesh_shape: Tuple[int, int],
             platform: Optional[str] = None, device=None) -> str:
    """The cache key of a *requested* config on a platform (by default
    ``device``'s fingerprint).  The signature's arity is its schema tag."""
    platform = (platform if platform is not None
                else platform_fingerprint(device))
    b = base_dict(config, mesh_shape)
    return "|".join([
        f"sig{len(SIGNATURE_FIELDS)}", platform,
        f"{b['rows']}x{b['cols']}", b["rule"], b["boundary"], b["backend"],
        f"mesh{b['mesh'][0]}x{b['mesh'][1]}",
        f"k{b['comm_every']}", f"ov{int(b['overlap'])}",
        f"T{b['sparse_tile']}",
    ])


def validate_plan(config: GolConfig, mesh_shape: Tuple[int, int],
                  plan: dict, platform: str = "cuda") -> GolConfig:
    """``config`` with ``plan`` applied, under the rules the build path
    runs: ``apply_plan``'s, the ghost ring's size on the one device
    (``validate_size``) or the shards' on a mesh (``validate_mesh``, the
    reference's feasibility rule), and a ``blocks`` tile's on the engine
    the plan lands on, for the platform's device.
    Raises :class:`ConfigError`."""
    mesh_shape = tuple(int(v) for v in mesh_shape)
    tuned = apply_plan(config, plan)
    ghost = tuned.rule.radius * tuned.comm_every
    if mesh_shape == (1, 1):
        validate_size(tuned.rows, tuned.cols, ghost)
    else:
        validate_mesh(tuned.rows, tuned.cols, mesh_shape, ghost)
    if plan.get("blocks") is not None:
        import torch

        from mpi_tpu_torch.backends.cuda import (
            check_blocks, plan_engine, plan_mesh_engine,
        )

        device = torch.device("cpu" if platform.startswith("cpu:")
                              else "cuda")
        kind = (plan_engine(tuned)[0] if mesh_shape == (1, 1)
                else plan_mesh_engine(tuned, *mesh_shape)[0])
        check_blocks(tuned, kind, device, plan["blocks"])
    return tuned


class TuneCache:
    """Thread-safe load and store of tune entries in one JSON file.

    A missing, unreadable or corrupt file is an EMPTY cache (noted on
    ``load_error``), never an exception: serving must not die on bad
    advisory state.  Writes go tmp + fsync + replace, so a crash in a save
    cannot corrupt a good file."""

    def __init__(self, path: Optional[str] = None):
        self.path = path if path is not None else default_cache_path()
        self._lock = threading.Lock()
        self._entries: Dict[str, dict] = {}
        self.load_error: Optional[str] = None
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as fh:
                raw = json.load(fh)
            entries = raw.get("entries")
            if not isinstance(entries, dict):
                raise ValueError("no 'entries' object")
            self._entries = {str(k): dict(v) for k, v in entries.items()
                             if isinstance(v, dict)}
        except FileNotFoundError:
            pass
        except Exception as e:  # noqa: BLE001 — corrupt cache = empty cache
            self.load_error = f"{type(e).__name__}: {e}"
            self._entries = {}

    def save(self) -> None:
        with self._lock:
            payload = {"version": FORMAT_VERSION,
                       "entries": dict(sorted(self._entries.items()))}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".tune_cache.",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(payload, fh, indent=1, sort_keys=True)
                fh.write("\n")
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def entries(self) -> Dict[str, dict]:
        with self._lock:
            return dict(self._entries)

    def get(self, key: str) -> Optional[dict]:
        with self._lock:
            e = self._entries.get(key)
            return dict(e) if e is not None else None

    def record(self, config: GolConfig, mesh_shape: Tuple[int, int],
               plan: dict, measured: dict,
               platform: Optional[str] = None, device=None) -> str:
        """Store one blessed winner (:meth:`save` persists it)."""
        platform = (platform if platform is not None
                    else platform_fingerprint(device))
        key = tune_key(config, mesh_shape, platform)
        entry = {
            "platform": platform,
            "base": base_dict(config, mesh_shape),
            "plan": dict(plan),
            "measured": dict(measured),
        }
        with self._lock:
            self._entries[key] = entry
        return key

    def resolve(self, config: GolConfig, mesh_shape: Tuple[int, int],
                platform: Optional[str] = None, device=None,
                ) -> Tuple[GolConfig, Optional[dict]]:
        """(possibly-tuned config, applied plan dict or None).

        Best effort by contract: no entry, an empty winning plan, or a
        stale plan that fails the current rules all return the config
        untouched: a bad cache can cost the speedup, never the run."""
        try:
            platform = (platform if platform is not None
                        else platform_fingerprint(device))
            key = tune_key(config, mesh_shape, platform)
        except Exception:  # noqa: BLE001 — advisory state, never fatal
            return config, None
        entry = self.get(key)
        if not entry:
            return config, None
        plan = entry.get("plan") or {}
        if not plan:
            return config, None
        try:
            tuned = validate_plan(config, mesh_shape, plan, platform)
        except ConfigError:
            return config, None
        return tuned, dict(plan)

    def check(self) -> List[str]:
        """Findings for ``python -m mpi_tpu_torch.tune --check``: every
        entry's base must reconstruct under the current config rules, its
        key must recompute to itself (a changed signature arity orphans
        it), and its plan must still apply."""
        findings: List[str] = []
        if self.load_error is not None:
            findings.append(f"cache file {self.path}: unreadable "
                            f"({self.load_error}) — treated as empty")
        for key, entry in sorted(self.entries().items()):
            base = entry.get("base")
            if not isinstance(base, dict):
                findings.append(f"entry {key}: no base config dict")
                continue
            try:
                cfg, mesh = config_from_base(base)
            except Exception as e:  # noqa: BLE001 — each entry judged alone
                findings.append(
                    f"entry {key}: base config no longer validates "
                    f"({type(e).__name__}: {e})")
                continue
            platform = str(entry.get("platform", ""))
            expect = tune_key(cfg, mesh, platform)
            if expect != key:
                findings.append(
                    f"entry {key}: signature no longer resolves "
                    f"(recomputes to {expect}; SIGNATURE_FIELDS arity or "
                    f"key schema changed — re-run the tuner)")
            plan = entry.get("plan") or {}
            try:
                validate_plan(cfg, mesh, plan, platform)
            except ConfigError as e:
                findings.append(
                    f"entry {key}: plan {plan} no longer validates "
                    f"under current config rules ({e})")
        return findings
