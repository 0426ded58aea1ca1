"""The port's spans on the profiler's clock and its kernel libraries'
load counters, on the CPU: an ``obs`` span is a ``record_function`` range
while ``torch.profiler`` records on its thread and calls nothing more
outside a profile; an engine carrying an ``Obs`` handle records
``engine.pass`` around each pass and, on a periodic padded grid,
``seam.extract``, ``seam.band`` and ``seam.stitch`` inside it, around the
ATen ops each makes; with ``obs=None`` an engine makes no
``record_function`` call, records nothing and launches and steps exactly
as an armed one; ``ops/_build.py`` counts the libraries it loads and the
seconds their builds and loads take, nvcc stubbed."""

from __future__ import annotations

import contextlib
import threading

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mpi_tpu_torch.backends.cuda import build_engine
from mpi_tpu_torch.config import GolConfig
from mpi_tpu_torch.models.rules import BOSCO, LIFE
from mpi_tpu_torch.obs import Obs
from mpi_tpu_torch.ops import _build, _launch

SEAM = ("seam.extract", "seam.band", "seam.stitch")


@pytest.fixture()
def record_functions(monkeypatch):
    """The names of every ``torch.profiler.record_function`` made while
    the test runs."""
    made = []
    real = torch.profiler.record_function

    def counting(name, *args, **kw):
        made.append(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return made


def _events(prof):
    """(name, start_ns, end_ns, is_user_annotation) of every host record."""
    return [(e.name(), e.start_ns(), e.end_ns(), e.is_user_annotation())
            for e in prof.profiler.kineto_results.events()]


def _inside(outer, inner) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


# ------------------------------------------------------------- Span itself

def test_span_opens_no_record_function_outside_a_profile(record_functions):
    obs = Obs()
    with obs.span("outer", depth=3):
        torch.ones(4) + 1
    assert record_functions == []
    assert [(r["name"], r["depth"]) for r in obs.tracer.snapshot()] == [
        ("outer", 3)]


def test_span_is_a_record_function_under_the_profiler(record_functions):
    obs = Obs()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.span("outer"):
            torch.ones(4) + 1
    assert record_functions == ["outer"]
    events = _events(prof)
    outer = next(e for e in events if e[0] == "outer")
    add = next(e for e in events if e[0] == "aten::add")
    assert outer[3] and not add[3] and _inside(outer, add)
    # the ring still records it, on its own clock
    assert [r["name"] for r in obs.tracer.snapshot()] == ["outer"]
    # an event (a pre-measured interval) stays in the ring only
    with profile(activities=[ProfilerActivity.CPU]):
        obs.event("measured", 0.5)
    assert record_functions == ["outer"]


def test_span_on_a_thread_the_profiler_does_not_record(record_functions):
    """The profiler's flag is per thread: a span on another thread than
    the profiling one opens no range."""
    obs = Obs()
    with profile(activities=[ProfilerActivity.CPU]):
        t = threading.Thread(target=lambda: obs.span("elsewhere")
                             .__enter__().__exit__(None, None, None))
        t.start()
        t.join()
    assert record_functions == []
    assert [r["name"] for r in obs.tracer.snapshot()] == ["elsewhere"]


# ------------------------------------------------------- an engine's spans

def _engine(cols, comm_every, rule=LIFE, boundary="periodic", rows=48):
    cfg = GolConfig(rows=rows, cols=cols, steps=0, rule=rule,
                    boundary=boundary, comm_every=comm_every)
    eng = build_engine(cfg, device="cpu", depths=[comm_every])
    eng.warm_up()
    return eng


def _passes(records):
    """Each ``engine.pass`` record with the records that lie inside it, in
    the order they began."""
    passes = [r for r in records if r["name"] == "engine.pass"]
    out = []
    for p in passes:
        t0, t1 = p["t_mono"], p["t_mono"] + p["dur_s"]
        inner = sorted((r for r in records if r is not p
                        and t0 <= r["t_mono"]
                        and r["t_mono"] + r["dur_s"] <= t1),
                       key=lambda r: r["t_mono"])
        out.append((p, [r["name"] for r in inner]))
    return out


@pytest.mark.parametrize("cols,K,steps,depths", [
    (60, 4, 10, [4, 4, 2]),     # Life, 1.875 words a row, a remainder pass
    (50, 2, 6, [2, 2, 2]),      # the band 4 d = 8 columns wide
    (100, 8, 8, [8]),           # one full pass
], ids=["rem", "narrow", "one"])
def test_armed_padded_engine_nests_the_seam_in_each_pass(cols, K, steps,
                                                         depths):
    eng = _engine(cols, K)
    assert eng.seam
    obs = Obs()
    eng.obs = obs
    eng.step(eng.init_grid(seed=5), steps)
    passes = _passes(obs.tracer.snapshot())
    assert [p["depth"] for p, _ in passes] == depths
    assert all("boards" not in p for p, _ in passes)
    assert [inner for _, inner in passes] == [list(SEAM)] * len(depths)


def test_batched_pass_carries_its_board_count():
    eng = _engine(60, 4)
    obs = Obs()
    eng.obs = obs
    grids = eng.stack_grids([eng.init_grid(seed=s) for s in (1, 2, 3)])
    eng.step_batched(grids, 4)
    (p, inner), = _passes(obs.tracer.snapshot())
    assert (p["depth"], p["boards"], inner) == (4, 3, list(SEAM))


@pytest.mark.parametrize("cols,rule,boundary,K", [
    (64, LIFE, "periodic", 4),    # K1 on whole words: no seam
    (64, BOSCO, "periodic", 1),   # K3
    (48, BOSCO, "dead", 3),       # K2
], ids=["K1", "K3", "K2"])
def test_armed_engine_without_a_seam_records_one_span_a_pass(cols, rule,
                                                             boundary, K):
    eng = _engine(cols, K, rule=rule, boundary=boundary)
    assert not eng.seam
    obs = Obs()
    eng.obs = obs
    eng.step(eng.init_grid(seed=2), 3 * K)
    assert [(r["name"], r["depth"]) for r in obs.tracer.snapshot()] == [
        ("engine.pass", K)] * 3


def test_seam_spans_enclose_their_aten_ops_under_the_profiler():
    eng = _engine(60, 4)
    eng.obs = Obs()
    grid = eng.init_grid(seed=9)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.step(grid, 4)
    events = _events(prof)
    spans = {e[0]: e for e in events if e[3]}
    assert set(spans) == {"engine.pass", *SEAM}
    for name in SEAM:
        assert _inside(spans["engine.pass"], spans[name])
    ops = [e for e in events if not e[3]]

    def within(name):
        return {e[0] for e in ops if _inside(spans[name], e)}

    assert "aten::index_select" in within("seam.extract")
    assert {"aten::index_add_", "aten::index_copy_"} <= within("seam.stitch")
    assert within("seam.band")
    # in order: the extraction, then the band's step, then the stitch
    assert spans["seam.extract"][2] <= spans["seam.band"][1] \
        <= spans["seam.band"][2] <= spans["seam.stitch"][1]


# ------------------------------------------------------------ obs is off


class _Launches:
    """A launch recorder (``ops/_launch.py``): every wrapper call's kernel,
    input shape and metadata, in order."""

    def __init__(self):
        self.calls = []

    def launch(self, kernel, x, meta):
        self.calls.append((kernel, tuple(x.shape), sorted(
            (k, str(v)) for k, v in meta.items())))
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def done(self, out):
        pass

    def exchange(self, *args):
        pass


def _run(eng, obs, steps, profiled):
    eng.obs = obs
    rec = _Launches()
    previous = _launch.arm(rec)
    try:
        with (profile(activities=[ProfilerActivity.CPU]) if profiled
              else contextlib.nullcontext()):
            out = eng.step(eng.init_grid(seed=11), steps)
            batch = eng.step_batched(eng.stack_grids(
                [eng.init_grid(seed=s) for s in (3, 4)]), steps)
    finally:
        _launch.arm(previous)
    return out, batch, rec.calls


@pytest.mark.parametrize("cols,rule,boundary,K", [
    (60, LIFE, "periodic", 4),    # K1 and the seam band
    (64, LIFE, "periodic", 4),    # K1
    (64, BOSCO, "periodic", 1),   # K3
    (48, BOSCO, "dead", 3),       # K2
], ids=["seam", "K1", "K3", "K2"])
def test_obs_off_records_nothing_and_steps_as_armed(record_functions, cols,
                                                    rule, boundary, K):
    eng = _engine(cols, K, rule=rule, boundary=boundary)
    off = _run(eng, None, 2 * K + 1, profiled=True)
    assert record_functions == []
    late = Obs()
    eng.obs = late          # armed only now: nothing earlier recorded
    assert late.tracer.snapshot() == []
    on = _run(eng, Obs(), 2 * K + 1, profiled=True)
    assert record_functions          # the armed engine's ranges
    assert off[0].equal(on[0]) and off[1].equal(on[1])
    assert off[2] == on[2] and off[2]


# ------------------------------------------------ the libraries' counters

_FAKE_NVCC = """#!/bin/sh
out=""
while [ $# -gt 0 ]; do
  case "$1" in -o) out="$2"; shift;; esac
  shift
done
echo "ptxas info : Used 32 registers" >&2
echo built > "$out"
"""


class _FakeLibrary:
    """What ``ctypes.CDLL`` gives for a fake library: any C function, whose
    signature may be set."""

    def __init__(self, path):
        self.path = path

    def __getattr__(self, name):
        fn = type("Fn", (), {})()
        setattr(self, name, fn)
        return fn


def test_build_counters_count_loads_and_their_seconds(monkeypatch,
                                                      tmp_path):
    (tmp_path / "bin").mkdir()
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL", _FakeLibrary)
    monkeypatch.setattr(_build, "_RULE_LIBS", {})
    monkeypatch.setattr(_build, "_VARIANT_LIBS", {})
    _build.load_library.cache_clear()
    try:
        builds, loads, seconds = (_build.builds, _build.loads,
                                  _build.load_seconds)
        _build.load_rule_library("bit", LIFE)      # one nvcc, one load
        assert (_build.builds - builds, _build.loads - loads) == (1, 1)
        assert _build.load_seconds > seconds
        _build.load_rule_library("bit", LIFE)      # loaded once
        assert (_build.builds - builds, _build.loads - loads) == (1, 1)
        _build.load_library()                      # two sources: two nvcc
        _build.load_variant_library({"K2_ROWS": 64, "K2_COLS": 128})
        assert (_build.builds - builds, _build.loads - loads) == (4, 3)
        # a new process finds the libraries built: loads, and no nvcc
        monkeypatch.setattr(_build, "_RULE_LIBS", {})
        _build.load_library.cache_clear()
        before = _build.load_seconds
        _build.load_rule_library("bit", LIFE)
        _build.load_library()
        assert (_build.builds - builds, _build.loads - loads) == (4, 5)
        assert _build.load_seconds > before
    finally:
        _build.load_library.cache_clear()


def test_a_failed_load_counts_its_seconds_and_no_library(monkeypatch,
                                                         tmp_path):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_RULE_LIBS", {})
    loads, seconds = _build.loads, _build.load_seconds
    with pytest.raises(_build.BuildError, match="nvcc not found"):
        _build.load_rule_library("ltl", BOSCO)
    assert _build.loads == loads and _build.load_seconds > seconds
