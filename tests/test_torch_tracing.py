"""The port's span recorder (``csa_tpu_torch.utils.PhaseTimer``): spans
with a parent and a job, self time and the root-only ``TOTAL``, the
``record_function`` ranges under ``torch.profiler``, the spans that
``CSA_TPU_TORCH_TRACE`` writes on the trace's clock, the start-up spans
of a CLI process, the block stage's device-read counter, and the
benchmark's readers of them (``perfbench/metrics``)."""

import io
import json
import os
import pathlib
import re
import subprocess
import sys
import types

import pytest
import torch

from csa_tpu_torch import cli, utils
from csa_tpu_torch.index import engine
from csa_tpu_torch.io import fasta as fio
from csa_tpu_torch.utils import PROFILER, PhaseTimer

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from perfbench import manifest  # noqa: E402
from perfbench.run import PROFILE_LINE, Run  # noqa: E402

S = 10**8  # fake clock ticks of 0.1 s


@pytest.fixture
def clock(monkeypatch):
    """``perf_counter_ns`` of the recorder as a list of readings."""
    readings = []
    monkeypatch.setattr(utils, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: readings.pop(0)))
    return readings


def _timer():
    t = PhaseTimer()
    t.enabled = True
    return t


def test_spans_nest_with_their_parent_and_job(clock):
    t = _timer()
    clock += [1 * S, 2 * S, 5 * S, 7 * S, 8 * S, 9 * S, 9 * S, 9 * S,
              10 * S, 12 * S, 13 * S, 14 * S]
    with t.job("cli.main", 0):
        with t.phase("a"):
            with t.phase("b"):
                pass
        with t.phase("c"):
            pass
        with t.phase("a"):
            pass
    with t.job("cli.main", 11 * S):
        with t.phase("c"):
            pass
    got = [(s.name, s.start // S, s.end // S,
            t.spans[s.parent].name if s.parent >= 0 else None, s.job)
           for s in t.spans]
    assert got == [("cli.main", 0, 10, None, 1), ("a", 1, 7, "cli.main", 1),
                   ("b", 2, 5, "a", 1), ("c", 8, 9, "cli.main", 1),
                   ("a", 9, 9, "cli.main", 1),
                   ("cli.main", 11, 14, None, 2), ("c", 12, 13, "cli.main", 2)]
    assert t.counts == {"cli.main": 2, "a": 2, "b": 1, "c": 2}
    assert t.phases["a"] == pytest.approx(0.6)


def test_parent_is_the_innermost_open_span_of_the_same_thread():
    import threading

    t = _timer()
    seen = {}

    def worker():
        with t.phase("in_thread"):
            pass

    with t.phase("outer"):
        th = threading.Thread(target=worker)
        th.start()
        th.join(timeout=30)
        assert not th.is_alive()
        with t.phase("inner"):
            pass
    for s in t.spans:
        seen[s.name] = t.spans[s.parent].name if s.parent >= 0 else None
    assert seen == {"outer": None, "in_thread": None, "inner": "outer"}


def test_self_time_and_a_total_of_root_spans(clock):
    t = _timer()
    # cli.main 0-10 holding a 1-7 (b 2-5 inside it) and c 8-9; the
    # start-up span -5-0 is a root of the same job
    clock += [1 * S, 2 * S, 5 * S, 7 * S, 8 * S, 9 * S, 10 * S]
    with t.job("cli.main", 0):
        t.record("startup.imports", -5 * S, 0)
        with t.phase("a"):
            with t.phase("b"):
                pass
        with t.phase("c"):
            pass
    own = t.self_seconds()
    assert own == pytest.approx({"cli.main": 0.3, "startup.imports": 0.5,
                                 "a": 0.3, "b": 0.3, "c": 0.1})
    assert t.root_seconds() == pytest.approx(1.5)
    assert [s.job for s in t.spans] == [1, 1, 1, 1, 1]
    out = io.StringIO()
    t.add("idx.device_reads", 3)
    t.report(out)
    lines = out.getvalue().splitlines()
    parsed = {m.group(1): float(m.group(2))
              for m in map(PROFILE_LINE.match, lines) if m}
    assert parsed == pytest.approx({"cli.main": 1.0, "startup.imports": 0.5,
                                    "a": 0.6, "b": 0.3, "c": 0.1})
    assert any(re.fullmatch(r">   a +0\.600s  self +0\.300s", ln)
               for ln in lines)
    total = [ln for ln in lines if ln.startswith(">   TOTAL")]
    assert len(total) == 1 and total[0].split()[-1] == "1.500s"
    assert "> [profile] idx.device_reads: 3" in lines


def test_a_disabled_timer_records_nothing():
    t = PhaseTimer()
    with t.job("cli.main", 0):
        with t.phase("a"):
            t.record("startup.imports", 0, 1)
            t.add("dp_cells", 5)
    t.startup = True
    with t.startup_phase("startup.cuda_context"):
        pass
    assert not (t.spans or t.phases or t.counts or t.counters)
    assert t.jobs == 0


def test_spans_are_ranges_of_a_running_profiler():
    from torch.profiler import ProfilerActivity, profile

    t = _timer()
    with t.phase("outside.before"):
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with t.phase("tracing.outer"):
            with t.phase("tracing.inner"):
                torch.ones(4).sum()
    names = [e.name for e in prof.events()]
    assert names.count("tracing.outer") == 1
    assert names.count("tracing.inner") == 1
    assert "outside.before" not in names
    assert [s.ranged for s in t.spans] == [False, True, True]
    # only the span no range carries is written by torch_trace
    assert [e["name"] for e in t.chrome_events(0.0)] == ["outside.before"]


def _events(path):
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_a_cli_process_writes_its_spans_on_the_trace_clock(tmp_path):
    src = FIX / "tiny" / "t1.txt"
    (tmp_path / src.name).write_bytes(src.read_bytes())
    trace = tmp_path / "trace"
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "CSA_TPU_TORCH_TRACE": str(trace)}
    proc = subprocess.run(
        [sys.executable, "-m", "csa_tpu_torch.cli", "R", src.name,
         "--device", "cpu", "--profile"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    phases = {m.group(1): float(m.group(2))
              for m in map(PROFILE_LINE.match, proc.stdout.splitlines()) if m}
    for name in ("startup.imports", "cli.main", "io.load_fasta",
                 "rot.artifacts", "rot.artifacts.fasta",
                 "rot.artifacts.blocks"):
        assert name in phases, name
    assert phases["rot.artifacts"] >= phases["rot.artifacts.blocks"]
    assert "rotation phase" not in proc.stdout
    events = _events(trace / "trace.json")
    spans = {e["name"]: e for e in events if e.get("cat") == "csa_span"}
    assert set(spans) == {"startup.imports", "cli.main"}
    imports, main = spans["startup.imports"], spans["cli.main"]
    assert imports["args"] == {"job": 1, "parent": None}
    assert main["args"] == {"job": 1, "parent": None}
    assert imports["ts"] + imports["dur"] <= main["ts"]
    assert main["dur"] / 1e6 == pytest.approx(phases["cli.main"], abs=2e-3)
    load = [e for e in events if e["name"] == "io.load_fasta"]
    assert len(load) == 1 and load[0].get("cat") != "csa_span"
    assert load[0]["ts"] >= main["ts"] - 1e3
    assert load[0]["ts"] + load[0]["dur"] <= main["ts"] + main["dur"] + 1e3


def test_an_in_process_main_records_no_start_up(tmp_path, monkeypatch,
                                                capsys):
    src = FIX / "tiny" / "t1.txt"
    (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.chdir(tmp_path)
    PROFILER.reset()
    try:
        assert cli.main(["R", src.name, "--device", "cpu", "--profile"]) == 0
        names = {s.name for s in PROFILER.spans}
        roots = [s for s in PROFILER.spans if s.parent < 0]
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    out = capsys.readouterr().out
    assert not any(n.startswith("startup.") for n in names)
    assert "startup." not in out
    assert [s.name for s in roots] == ["cli.main"]
    assert {"rot.artifacts.fasta", "rot.artifacts.blocks"} <= names
    assert not PROFILER.startup


def test_alignment_output_and_anchor_parts_are_spans(tmp_path, monkeypatch):
    src = FIX / "tiny" / "t1.txt"
    (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.chdir(tmp_path)
    PROFILER.reset()
    try:
        assert cli.main([src.name, "--device", "cpu", "--profile"]) == 0
        spans = list(PROFILER.spans)
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    parent = {s.name: spans[s.parent].name for s in spans if s.parent >= 0}
    for name in ("align.anchors.sort", "align.anchors.attach",
                 "align.anchors.group"):
        assert parent[name] == "align.anchors"
    assert parent["align.save"] == parent["align.check_output"] == \
        "align.total"
    assert parent["align.total"] == "cli.main"


def test_the_block_stage_counts_its_device_reads(monkeypatch):
    encoded = fio.load_fasta(str(FIX / "tiny" / "t1.txt"),
                             log=io.StringIO()).encoded_all()
    calls = {"_refine": 0, "_dup_flag": 0}
    for name in calls:
        def counted(*a, _fn=getattr(engine, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(engine, name, counted)
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        engine.rotation_final_staged(encoded, "cpu")
        reads = PROFILER.counters["idx.device_reads"]
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    # level 0's two counts, one a refinement level, the duplicate check
    # when ties are left, and the tail's seven (two nonzero, the
    # expansion's size, three downloads, the count)
    assert calls["_refine"]
    assert reads == 2 + calls["_refine"] + calls["_dup_flag"] + 7


def _reader(name):
    return manifest.metric_reader(name)


def _run(jobs):
    run = Run(cell=None)
    run.jobs = jobs
    return run


def test_the_start_up_readers_take_the_children_without_the_profiler():
    def child(wall, imports, main, ctx, traced=False):
        return {"wall_s": wall, "ok": True, "traced": traced,
                "phases": {"startup.imports": imports, "cli.main": main,
                           "startup.cuda_context": ctx,
                           "startup.kernel_library": 0.25,
                           "startup.host_library": 0.125,
                           "rot.artifacts": 0.5}}

    run = _run([child(20.0, 9.0, 10.0, 5.0, traced=True),
                child(8.0, 4.0, 3.0, 0.5), child(9.0, 5.0, 3.5, 0.75),
                child(10.0, 6.0, 3.0, 0.625)])
    assert _reader("startup.imports_s")(run) == 5.0
    assert _reader("startup.cuda_s")(run) == 0.625 + 0.375
    assert _reader("startup.unspanned_s")(run) == 1.0
    assert _reader("startup.imports_s")(_run([])) is None
    assert _reader("startup.cuda_s")(_run([{"phases": {}}])) is None
    assert _reader("startup.unspanned_s")(
        _run([{"wall_s": 1.0, "phases": {"rot.artifacts": 0.5}}])) is None


def test_the_phase_and_counter_readers_take_the_median_job():
    def job(scale, reads):
        return {"wall_s": 1.0, "ok": True, "counters": {
            "idx.device_reads": reads, "dp_cells": 9.0}, "phases": {
            "align.anchors": 0.5 * scale, "align.anchors.sort": 0.2 * scale,
            "align.anchors.attach": 0.1 * scale,
            "align.anchors.group": 0.15 * scale,
            "align.save": 0.01 * scale, "align.check_output": 0.02 * scale,
            "rot.artifacts": 0.05 * scale,
            "rot.artifacts.blocks": 0.04 * scale}}

    run = _run([job(1, 40), job(2, 42), job(3, 40)])
    want = {"anchors.sort_ms": 400, "anchors.attach_ms": 200,
            "anchors.group_ms": 300, "align.output_ms": 60,
            "artifacts.blocks_ms": 80, "rotation.device_reads": 40}
    for name, value in want.items():
        assert _reader(name)(run) == pytest.approx(value), name
        # a program without the span or counter: no number, no error
        assert _reader(name)(_run([{"wall_s": 1.0, "phases": {}}])) is None


@pytest.mark.cuda
def test_a_cli_trace_on_the_card_puts_start_up_before_the_kernels(tmp_path):
    """One Primates R job of a fresh CLI process under
    ``CSA_TPU_TORCH_TRACE``: the context span ends before the first
    kernel starts, and the block stage's range holds the kernels it
    launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the check reads kernel events")
    src = FIX / "Primates.txt"
    (tmp_path / src.name).write_bytes(src.read_bytes())
    trace = tmp_path / "trace"
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "CSA_TPU_TORCH_TRACE": str(trace)}
    proc = subprocess.run(
        [sys.executable, "-m", "csa_tpu_torch.cli", "R", src.name,
         "--profile"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    events = _events(trace / "trace.json")
    kernels = [e for e in events if e.get("cat") == "kernel"]
    assert kernels
    host = [e for e in events
            if e.get("cat") in ("user_annotation", "csa_span")]
    ctx = [e for e in host if e["name"] == "startup.cuda_context"]
    assert len(ctx) == 1
    assert ctx[0]["ts"] + ctx[0]["dur"] <= min(k["ts"] for k in kernels)
    stage = [e for e in host if e["name"].startswith("rot.block_stage[")]
    assert len(stage) == 1
    s0, s1 = stage[0]["ts"], stage[0]["ts"] + stage[0]["dur"]
    launched = {e["args"]["correlation"] for e in events
                if e.get("cat") == "cuda_runtime"
                and s0 <= e["ts"] <= s1 and "correlation" in e.get("args", {})}
    inside = [k for k in kernels if k["args"].get("correlation") in launched]
    assert inside
    assert all(s0 <= k["ts"] and k["ts"] + k["dur"] <= s1 for k in inside)
    spans = {e["name"] for e in events if e.get("cat") == "csa_span"}
    assert {"startup.imports", "cli.main"} <= spans
