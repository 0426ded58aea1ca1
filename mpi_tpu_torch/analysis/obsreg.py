"""``obs-drift`` — the observability registry, extracted statically.

Dashboards parse ``/metrics`` and the trace JSONL, so the set of metric
families and span kinds is API.  Three artifacts describe it: the code
(the only authority), the README tables, and ``tools/obs_smoke.py``'s
runtime expectations.  This rule extracts the registry FROM THE CODE —
no import, pure ``ast`` — and cross-checks the other two in both
directions:

* every ``.span("name")`` / ``.event("name")`` literal emitted under
  ``mpi_tpu_torch/`` must have a row in the README span table, and every
  row must correspond to a real emission site (``phase:*`` names are built
  dynamically by ``Obs.phase_sink``; the known expansions live in
  ``KNOWN_DYNAMIC_SPANS``);
* every backticked ``mpi_tpu_*`` token in the README (brace patterns
  like ``mpi_tpu_http_bytes_{in,out}_total`` and ``*`` wildcards
  expand) must resolve to registered families, and every registered
  family must be mentioned by some token;
* every ``mpi_tpu_*`` string literal in ``tools/obs_smoke.py`` must
  name a registered family (modulo ``_bucket``/``_count``/``_sum``
  sample suffixes), and every ``*SPAN_KINDS`` set element there must
  be an emitted span kind.

The port keeps the reference's family and span names, so the one
README and the one ``tools/obs_smoke.py`` describe both packages; here
the code that is the authority is ``mpi_tpu_torch/``.  The helpers
(:func:`required_families`, :func:`cluster_families` and the like) give
the port's own lists, extracted from its code.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from mpi_tpu_torch.analysis import (
    Finding, Rule, SourceFile, default_files, repo_root,
)

RULE_NAME = "obs-drift"
# the package whose code is the registry's authority: the port keeps the
# reference's family and span names, so README.md's tables and
# tools/obs_smoke.py describe both packages
PACKAGE = "mpi_tpu_torch/"

_REGISTER_KINDS = {
    "histogram": "histogram", "counter": "counter", "gauge": "gauge",
    "gauge_fn": "gauge", "counter_fn": "counter",
}
# span names assembled at runtime (Obs.phase_sink f-string) and the
# PhaseTimer phases that feed it
KNOWN_DYNAMIC_SPANS = {"phase:setup", "phase:steady"}
# trace-context keys every schema-v2 record may carry (obs/tracectx.py):
# the README span table must document them as columns and obs_smoke's
# TRACE_CTX_KEYS literal must match exactly — checked only when the
# scanned tree actually ships tracectx (fixture corpora predate it)
TRACE_CONTEXT_COLUMNS = ("trace_id", "span_id", "parent_span_id")

# families registered only when --telemetry-interval-s arms the sampler:
# present on an ARMED scrape, absent otherwise — like the
# cluster families, they belong to neither required list
SLO_MODULES = (PACKAGE + "obs/slo.py", PACKAGE + "obs/timeseries.py")
# families registered only when --admission/--tenants-file arms the
# admission layer — same armed-only discipline as SLO_MODULES
ADMISSION_PREFIX = PACKAGE + "admission/"
# families registered only when --flight-recorder/--anomaly-detect arm
# the flight plane — same armed-only discipline
FLIGHT_MODULES = (PACKAGE + "obs/flight.py", PACKAGE + "obs/devmem.py",
                  PACKAGE + "obs/anomaly.py")
CLUSTER_PREFIX = PACKAGE + "cluster/"
AIO_MODULE = PACKAGE + "serve/aio.py"

_BACKTICK = re.compile(r"`([^`]+)`")
_FAMILY_TOKEN = re.compile(r"^mpi_tpu_[a-z0-9_{},*]+$")
_FAMILY_LIT = re.compile(r"^mpi_tpu_[a-z0-9_]*[a-z0-9]$")
_SAMPLE_SUFFIXES = ("_bucket", "_count", "_sum")


def extract_registry(root: Optional[str] = None,
                     files: Optional[Sequence[SourceFile]] = None) -> dict:
    """The statically-extracted observability registry of the tree:
    ``{"metrics": {family: {"kind", "module", "labels"}},
    "spans": {name: module}}``.  Scans ``mpi_tpu_torch/`` only — that is
    where every registration and emission site lives."""
    root = os.path.abspath(root or repo_root())
    if files is None:
        files = []
        for p in default_files(root):
            rel = os.path.relpath(p, root).replace(os.sep, "/")
            if rel.startswith(PACKAGE):
                try:
                    files.append(SourceFile(p, root))
                except (SyntaxError, OSError):
                    continue
    metrics: Dict[str, dict] = {}
    spans: Dict[str, str] = {}
    for sf in files:
        if not sf.rel.startswith(PACKAGE):
            continue
        attr_to_family: Dict[str, str] = {}
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            lit = _first_literal(node)
            if isinstance(node.func, ast.Attribute):
                meth = node.func.attr
                if meth in _REGISTER_KINDS and lit and \
                        lit.startswith("mpi_tpu_"):
                    metrics.setdefault(lit, {
                        "kind": _REGISTER_KINDS[meth],
                        "module": sf.rel, "labels": set()})
                elif meth in ("span", "event") and lit:
                    spans.setdefault(lit, sf.rel)
            elif isinstance(node.func, ast.Name) and node.func.id == "_span" \
                    and len(node.args) >= 2 \
                    and isinstance(node.args[1], ast.Constant) \
                    and isinstance(node.args[1].value, str):
                # the serve layer's obs-optional helper: _span(obs, "name")
                spans.setdefault(node.args[1].value, sf.rel)
        # label keys ride on .series(...) calls against the bound handle
        # (self.wire_encode = m.histogram(...); self.wire_encode.series(
        # format=..., transport=...)) — map handles back to families,
        # then collect the kwarg names
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call):
                lit = _first_literal(node.value)
                t = node.targets[0]
                if lit and lit in metrics:
                    if isinstance(t, ast.Attribute):
                        attr_to_family[t.attr] = lit
                    elif isinstance(t, ast.Name):
                        attr_to_family[t.id] = lit
        # re-walk series calls now that attr_to_family is complete
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == "series":
                tgt = node.func.value
                fam = None
                if isinstance(tgt, ast.Attribute):
                    fam = attr_to_family.get(tgt.attr)
                elif isinstance(tgt, ast.Name):
                    fam = attr_to_family.get(tgt.id)
                if fam in metrics:
                    metrics[fam]["labels"].update(
                        kw.arg for kw in node.keywords if kw.arg)
    for fam in metrics.values():
        fam["labels"] = sorted(fam["labels"])
    return {"metrics": metrics, "spans": spans}


def _first_literal(call: ast.Call) -> Optional[str]:
    if call.args and isinstance(call.args[0], ast.Constant) \
            and isinstance(call.args[0].value, str):
        return call.args[0].value
    return None


def required_families(registry: Optional[dict] = None) -> Tuple[List[str],
                                                                List[str]]:
    """(core, aio) family lists for the runtime smoke: aio families are
    the ones ``serve/aio.py`` registers at construction; everything
    else must be present on any instrumented scrape.  Families
    registered by ``mpi_tpu_torch/cluster/`` exist only when serving with
    ``--peers`` and belong to neither list (see
    :func:`cluster_families`); likewise the ``SLO_MODULES`` families
    exist only when ``--telemetry-interval-s`` arms the sampler (see
    :func:`slo_families`), the ``ADMISSION_PREFIX`` families only
    when ``--admission``/``--tenants-file`` arms admission control
    (see :func:`admission_families`), and the ``FLIGHT_MODULES``
    families only when ``--flight-recorder``/``--anomaly-detect`` arm
    the flight plane (see :func:`flight_families`)."""
    registry = registry or extract_registry()
    core, aio = [], []
    for name, info in sorted(registry["metrics"].items()):
        if info["module"].startswith(CLUSTER_PREFIX) \
                or info["module"].startswith(ADMISSION_PREFIX) \
                or info["module"] in SLO_MODULES \
                or info["module"] in FLIGHT_MODULES:
            continue
        (aio if info["module"] == AIO_MODULE else core).append(name)
    return core, aio


def cluster_families(registry: Optional[dict] = None) -> List[str]:
    """Families registered by ``mpi_tpu_torch/cluster/`` — present on a scrape
    only in cluster mode (``--peers``), so the runtime smoke checks them
    separately from the always-on core set."""
    registry = registry or extract_registry()
    return sorted(name for name, info in registry["metrics"].items()
                  if info["module"].startswith(CLUSTER_PREFIX))


def slo_families(registry: Optional[dict] = None) -> List[str]:
    """Families registered by the telemetry/SLO modules — present on a
    scrape only when ``--telemetry-interval-s`` (or ``--slo-file``) arms
    the sampler.  The runtime smoke pins them ABSENT on an unarmed
    scrape (the default-off purity gate) and present on an armed one."""
    registry = registry or extract_registry()
    return sorted(name for name, info in registry["metrics"].items()
                  if info["module"] in SLO_MODULES)


def admission_families(registry: Optional[dict] = None) -> List[str]:
    """Families registered by ``mpi_tpu_torch/admission/`` — present on a
    scrape only when ``--admission``/``--tenants-file`` arms admission
    control.  The runtime smoke pins them ABSENT on an unarmed scrape
    (the default-off purity gate) and present on an armed one."""
    registry = registry or extract_registry()
    return sorted(name for name, info in registry["metrics"].items()
                  if info["module"].startswith(ADMISSION_PREFIX))


def flight_families(registry: Optional[dict] = None) -> List[str]:
    """Families registered by the flight-plane modules — present on a
    scrape only when ``--flight-recorder``/``--anomaly-detect`` arm the
    recorder (devmem additionally needs telemetry armed).  The runtime
    smoke pins them ABSENT on an unarmed scrape (the default-off purity
    gate) and present on an armed one."""
    registry = registry or extract_registry()
    return sorted(name for name, info in registry["metrics"].items()
                  if info["module"] in FLIGHT_MODULES)


# -- README cross-check ---------------------------------------------------

def _expand_token(token: str) -> List[str]:
    """``a_{b,c}_d`` -> [a_b_d, a_c_d]; trailing ``*`` kept as wildcard."""
    parts: List[List[str]] = [[""]]
    for seg in re.split(r"(\{[^}]*\})", token):
        if seg.startswith("{") and seg.endswith("}"):
            alts = seg[1:-1].split(",")
        else:
            alts = [seg]
        parts = [p + [a] for p in parts for a in alts]
        parts = [["".join(p)] for p in parts]
    return [p[0] for p in parts]


def _readme_span_header(lines: Sequence[str]) -> Optional[Tuple[int,
                                                                List[str]]]:
    """(line_no, header cells) of the first table whose header's first
    column is ``span``, or None."""
    for i, line in enumerate(lines, start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if cells and cells[0].strip("`* ").lower() == "span":
            return i, cells
    return None


def _readme_span_rows(lines: Sequence[str]) -> List[Tuple[int, List[str]]]:
    """(line_no, [span names]) per row of any table whose header's
    first column is ``span``."""
    rows: List[Tuple[int, List[str]]] = []
    in_table = False
    for i, line in enumerate(lines, start=1):
        stripped = line.strip()
        if not stripped.startswith("|"):
            in_table = False
            continue
        cells = [c.strip() for c in stripped.strip("|").split("|")]
        if not in_table:
            if cells and cells[0].strip("`* ").lower() == "span":
                in_table = True
            continue
        if set(cells[0]) <= {"-", ":", " "}:
            continue
        names = _BACKTICK.findall(cells[0])
        if names:
            rows.append((i, names))
    return rows


def check_tree(root: str, files: Sequence[SourceFile],
               readme_path: Optional[str] = None,
               smoke_path: Optional[str] = None) -> List[Finding]:
    readme_path = readme_path or os.path.join(root, "README.md")
    smoke_path = smoke_path or os.path.join(root, "tools", "obs_smoke.py")
    registry = extract_registry(root, [sf for sf in files
                                       if sf.rel.startswith(PACKAGE)])
    metrics, spans = registry["metrics"], registry["spans"]
    # the trace-context contract exists only where tracectx shipped —
    # fixture corpora without it must not be held to it
    has_tracectx = any(sf.rel == PACKAGE + "obs/tracectx.py" for sf in files)
    findings: List[Finding] = []

    def mk(rel: str, line: int, msg: str) -> Finding:
        return Finding(RULE_NAME, rel, line, 0, msg)

    # -- README ----------------------------------------------------------
    if os.path.exists(readme_path):
        readme_rel = os.path.relpath(readme_path, root).replace(os.sep, "/")
        with open(readme_path, "r", encoding="utf-8") as f:
            readme = f.read()
        rlines = readme.splitlines()
        rows = _readme_span_rows(rlines)
        table_spans: Dict[str, int] = {}
        for line_no, names in rows:
            for n in names:
                table_spans.setdefault(n, line_no)
        for name, line_no in sorted(table_spans.items()):
            if name not in spans and name not in KNOWN_DYNAMIC_SPANS:
                findings.append(mk(
                    readme_rel, line_no,
                    f"README span table lists '{name}' but no call site "
                    f"under {PACKAGE} emits it"))
        table_line = rows[0][0] if rows else 1
        for name, module in sorted(spans.items()):
            if name not in table_spans:
                findings.append(mk(
                    readme_rel, table_line,
                    f"span kind '{name}' (emitted by {module}) is missing "
                    f"from the README span table"))
        if not rows:
            findings.append(mk(readme_rel, 1,
                               "README has no span table (header row "
                               "starting with 'span')"))
        if has_tracectx and rows:
            header = _readme_span_header(rlines)
            if header is not None:
                hdr_line, hdr_cells = header
                cols = {c.strip("`* ").lower() for c in hdr_cells}
                missing_cols = [c for c in TRACE_CONTEXT_COLUMNS
                                if c not in cols]
                if missing_cols:
                    findings.append(mk(
                        readme_rel, hdr_line,
                        f"README span table lacks trace-context "
                        f"column(s) {missing_cols} — schema v2 "
                        f"(obs/tracectx.py) adds them to every span"))
        # metric-family mentions, both directions
        mentioned: Set[str] = set()
        for i, line in enumerate(rlines, start=1):
            for tok in _BACKTICK.findall(line):
                tok = tok.strip()
                if not _FAMILY_TOKEN.match(tok):
                    continue
                hit = False
                for name in _expand_token(tok):
                    if name.endswith("*"):
                        pref = name[:-1]
                        matches = [f for f in metrics if f.startswith(pref)]
                        mentioned.update(matches)
                        hit = hit or bool(matches)
                    elif name in metrics:
                        mentioned.add(name)
                        hit = True
                if not hit:
                    findings.append(mk(
                        readme_rel, i,
                        f"README mentions metric '{tok}' but no such "
                        f"family is registered under {PACKAGE}"))
        for name, info in sorted(metrics.items()):
            if name not in mentioned:
                findings.append(mk(
                    readme_rel, 1,
                    f"metric family '{name}' (registered by "
                    f"{info['module']}) is not mentioned anywhere in the "
                    f"README"))

    # -- obs_smoke -------------------------------------------------------
    if os.path.exists(smoke_path):
        smoke_rel = os.path.relpath(smoke_path, root).replace(os.sep, "/")
        with open(smoke_path, "r", encoding="utf-8") as f:
            smoke_src = f.read()
        smoke_tree = ast.parse(smoke_src, filename=smoke_path)
        for node in ast.walk(smoke_tree):
            if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                    and _FAMILY_LIT.match(node.value):
                base = node.value
                for suf in _SAMPLE_SUFFIXES:
                    if base.endswith(suf) and base not in metrics:
                        base = base[: -len(suf)]
                        break
                if base not in metrics:
                    findings.append(mk(
                        smoke_rel, node.lineno,
                        f"obs_smoke expects metric '{node.value}' but no "
                        f"such family is registered under {PACKAGE}"))
            elif isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and node.targets[0].id.endswith("SPAN_KINDS"):
                for elt in ast.walk(node.value):
                    if isinstance(elt, ast.Constant) \
                            and isinstance(elt.value, str) \
                            and elt.value not in spans \
                            and elt.value not in KNOWN_DYNAMIC_SPANS:
                        findings.append(mk(
                            smoke_rel, elt.lineno,
                            f"obs_smoke requires span kind '{elt.value}' "
                            f"but no call site under {PACKAGE} emits it"))
        if has_tracectx:
            ctx_keys: Optional[Set[str]] = None
            ctx_line = 1
            for node in ast.walk(smoke_tree):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and node.targets[0].id == "TRACE_CTX_KEYS":
                    ctx_line = node.lineno
                    ctx_keys = {elt.value for elt in ast.walk(node.value)
                                if isinstance(elt, ast.Constant)
                                and isinstance(elt.value, str)}
            if ctx_keys is None:
                findings.append(mk(
                    smoke_rel, 1,
                    "obs_smoke lacks a TRACE_CTX_KEYS literal naming the "
                    "schema-v2 trace-context keys "
                    f"{list(TRACE_CONTEXT_COLUMNS)}"))
            elif ctx_keys != set(TRACE_CONTEXT_COLUMNS):
                findings.append(mk(
                    smoke_rel, ctx_line,
                    f"obs_smoke TRACE_CTX_KEYS {sorted(ctx_keys)} drifted "
                    f"from the schema-v2 context keys "
                    f"{sorted(TRACE_CONTEXT_COLUMNS)}"))
    return findings


def check_project(root: str, files: Sequence[SourceFile]) -> List[Finding]:
    return check_tree(root, files)


RULE = Rule(
    name=RULE_NAME,
    doc="statically-extracted metric/span registry must match the README "
        "tables and tools/obs_smoke.py expectations, both directions",
    project_check=check_project,
)
