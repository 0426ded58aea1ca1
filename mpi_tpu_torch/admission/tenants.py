"""Tenant registry: who may spend what.

Tenants are declared in a JSON file (``--tenants-file``) or fall back to
a single unlimited ``default`` tenant.  Quotas are metered in **ledger
currency** — device-seconds and cells over a sliding window — plus a cap
on concurrent sessions; they are *not* raw request counts, so a 65536²
step and a 64² step debit what they actually cost.

The file shape mirrors the SLO file (a bare list, or an object with a
``tenants`` key), and validation follows ``slo.normalize_objectives``'s
discipline exactly: every error is a ``ConfigError`` naming the
offending tenant and key, unknown keys are rejected, and duplicates are
refused.  A registry always contains the ``default`` tenant — requests
without an ``X-Gol-Tenant`` header land there, and when the file does
not declare it, an unlimited entry is appended so header-less traffic
behaves exactly as before this subsystem existed.

Tenant spec fields (all but ``name`` optional):

- ``device_s_per_window``: float > 0, device-seconds the tenant may
  settle per window (``null``/absent = unlimited)
- ``cells_per_window``: int > 0, cell-updates per window (unlimited
  when absent)
- ``window_s``: float > 0, the sliding-window length (default 60s)
- ``max_sessions``: int >= 1, concurrent live sessions (unlimited
  when absent)
- ``default_class``: priority class for requests with no override
  (default ``standard``)
- ``max_class``: the highest class the tenant may request; overrides
  above it are capped, not rejected (default ``interactive``)
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from mpi_tpu_torch.config import ConfigError
from mpi_tpu_torch.admission.sched import CLASSES, CLASS_RANK, DEFAULT_CLASS, \
    clamp_class

DEFAULT_TENANT = "default"

_TENANT_KEYS = {"name", "device_s_per_window", "cells_per_window",
                "window_s", "max_sessions", "default_class", "max_class"}


def _normalize_tenant(obj: dict, seen: set) -> dict:
    if not isinstance(obj, dict):
        raise ConfigError(f"tenant entry must be an object, got {obj!r}")
    name = obj.get("name")
    if not isinstance(name, str) or not name:
        raise ConfigError(f"tenant needs a non-empty string name, "
                          f"got {name!r}")
    if name in seen:
        raise ConfigError(f"duplicate tenant name {name!r}")
    seen.add(name)
    unknown = set(obj) - _TENANT_KEYS
    if unknown:
        raise ConfigError(f"{name}: unknown keys {sorted(unknown)}")

    device_s = obj.get("device_s_per_window")
    if device_s is not None:
        if not isinstance(device_s, (int, float)) \
                or isinstance(device_s, bool) or device_s <= 0:
            raise ConfigError(f"{name}: device_s_per_window must be a "
                              f"positive number, got {device_s!r}")
        device_s = float(device_s)
    cells = obj.get("cells_per_window")
    if cells is not None:
        if not isinstance(cells, int) or isinstance(cells, bool) \
                or cells <= 0:
            raise ConfigError(f"{name}: cells_per_window must be a "
                              f"positive int, got {cells!r}")
    window_s = obj.get("window_s", 60.0)
    if not isinstance(window_s, (int, float)) or isinstance(window_s, bool) \
            or window_s <= 0:
        raise ConfigError(f"{name}: window_s must be a positive number, "
                          f"got {window_s!r}")
    max_sessions = obj.get("max_sessions")
    if max_sessions is not None:
        if not isinstance(max_sessions, int) or isinstance(max_sessions, bool) \
                or max_sessions < 1:
            raise ConfigError(f"{name}: max_sessions must be an int >= 1, "
                              f"got {max_sessions!r}")
    default_class = obj.get("default_class", DEFAULT_CLASS)
    if default_class not in CLASSES:
        raise ConfigError(f"{name}: default_class must be one of "
                          f"{list(CLASSES)}, got {default_class!r}")
    max_class = obj.get("max_class", CLASSES[0])
    if max_class not in CLASSES:
        raise ConfigError(f"{name}: max_class must be one of "
                          f"{list(CLASSES)}, got {max_class!r}")
    if CLASS_RANK[default_class] < CLASS_RANK[max_class]:
        raise ConfigError(f"{name}: default_class {default_class!r} outranks "
                          f"max_class {max_class!r}")
    return {
        "name": name,
        "device_s_per_window": device_s,
        "cells_per_window": cells,
        "window_s": float(window_s),
        "max_sessions": max_sessions,
        "default_class": default_class,
        "max_class": max_class,
    }


def normalize_tenants(raw) -> Dict[str, dict]:
    """Validate a tenants document (bare list or ``{"tenants": [...]}``)
    into ``{name: spec}``, guaranteeing the default tenant exists."""
    if isinstance(raw, dict):
        unknown = set(raw) - {"tenants"}
        if unknown:
            raise ConfigError(f"unknown top-level keys {sorted(unknown)}")
        raw = raw.get("tenants")
    if not isinstance(raw, list) or not raw:
        raise ConfigError("tenants file needs a non-empty list of tenants "
                          "(bare or under a 'tenants' key)")
    seen: set = set()
    specs = [_normalize_tenant(obj, seen) for obj in raw]
    if DEFAULT_TENANT not in seen:
        specs.append(_normalize_tenant({"name": DEFAULT_TENANT}, seen))
    return {spec["name"]: spec for spec in specs}


def default_tenants() -> Dict[str, dict]:
    """The registry used when no ``--tenants-file`` is given: one
    unlimited default tenant (admission armed, nothing constrained)."""
    return normalize_tenants([{"name": DEFAULT_TENANT}])


def load_tenants_file(path: str) -> Dict[str, dict]:
    try:
        with open(path, "r", encoding="utf-8") as fh:
            raw = json.load(fh)
    except OSError as e:
        raise ConfigError(f"cannot read tenants file {path!r}: {e}") from e
    except ValueError as e:
        raise ConfigError(f"tenants file {path!r} is not JSON: {e}") from e
    return normalize_tenants(raw)


class TenantRegistry:
    """Immutable view over the normalized tenant specs."""

    def __init__(self, specs: Dict[str, dict]):
        if DEFAULT_TENANT not in specs:
            raise ConfigError(f"registry needs the {DEFAULT_TENANT!r} tenant")
        self._specs = dict(specs)

    def names(self) -> List[str]:
        return sorted(self._specs)

    def get(self, name: str) -> dict:
        return self._specs[name]

    def resolve(self, header: Optional[str]) -> str:
        """Header value -> tenant name.  No header means the default
        tenant; an unknown tenant is a client error (400)."""
        if header is None or header == "":
            return DEFAULT_TENANT
        if header not in self._specs:
            raise ConfigError(f"unknown tenant {header!r}")
        return header

    def resolve_class(self, tenant: str, requested: Optional[str]) -> str:
        """The class a request gets: the tenant default when nothing was
        asked, otherwise the ask capped at the tenant's ceiling.  An
        unknown class name is a client error."""
        spec = self._specs[tenant]
        if requested is None or requested == "":
            return spec["default_class"]
        if requested not in CLASSES:
            raise ConfigError(f"unknown priority class {requested!r} "
                              f"(one of {list(CLASSES)})")
        return clamp_class(requested, spec["max_class"])
