"""``BENCHMARK.json`` against the benchmark's contract: names, units and
lengths, and every configuration, traffic and metric file found by name."""

import json
import re

import pytest

from portbench import harness

M = harness.load_manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
METRICS = M["end_to_end"] + M["per_layer"]
CELLS = [c["name"] for c in M["workloads"]]


def _line(text, limit=200):
    return 1 <= len(text) <= limit and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("entry", METRICS + M["configs"] + M["workloads"],
                         ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.fullmatch(entry["name"]), entry["name"]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.fullmatch(entry[key])


def test_names_unique():
    for group in (METRICS, M["configs"], M["workloads"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    assert len({(c["config"], c["traffic"]) for c in M["workloads"]}) \
        == len(M["workloads"])


@pytest.mark.parametrize("metric", METRICS, ids=lambda e: e["name"])
def test_metric_fields(metric):
    assert UNIT.fullmatch(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    for cell in metric.get("workloads", []):
        assert cell in CELLS
    if metric in M["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert _line(metric["layer"])
        assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
        assert metric["workloads"], "a per-layer metric lists its cells"


@pytest.mark.parametrize("cell", M["workloads"], ids=lambda e: e["name"])
def test_cell_files_found_by_name(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] == 1 and _line(cell["why"])
    cfg = harness.config_file(M, cell["config"])
    assert {"rule", "boundary", "comm_every"} <= set(cfg)
    traffic = harness.traffic_file(cell["traffic"])
    assert (harness.PACKAGE / "kinds" / f"{traffic['kind']}.py").is_file()
    e2e = [m["name"] for m in harness.end_to_end(M, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = harness.per_layer(M, cell["name"])
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("cfg", M["configs"], ids=lambda e: e["name"])
def test_config_entries(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert cfg["file"].startswith("portbench/configs/")
    assert (harness.ROOT / cfg["file"]).is_file()
    assert _line(cfg["source"]) and _line(cfg["why"])
    assert cfg["reduced"] == []
    assert any(c["config"] == cfg["name"] for c in M["workloads"])


def test_setup_bound_and_budget():
    setup = next(m for m in M["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25 and "workloads" not in setup
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
