"""Busy time, idle gaps by what the host was doing, and kernel names from
trace events (synthetic, in microseconds)."""

import json

import pytest

from perfbench import outputs, tracing

DEVICE = [("k1", 10, 20), ("k2", 15, 30), ("Memcpy HtoD (Pageable)", 50, 60)]
SPANS = [("job", 0, 100), ("phase.a", 5, 40), ("phase.b", 45, 90),
         ("phase.b.inner", 70, 80)]


def test_busy_is_the_union_inside_the_window():
    assert tracing.merged(DEVICE) == [(10, 30), (50, 60)]
    assert tracing.busy_us(DEVICE, 0, 100) == 30
    assert tracing.busy_us(DEVICE, 25, 55) == 10


def test_idle_time_goes_to_the_innermost_span():
    got = dict(tracing.idle_by_host(DEVICE, SPANS, 0, 120, "between"))
    # idle: 0-10, 30-50, 60-120
    assert got["job"] * 1e6 == pytest.approx(5 + 5 + 10)
    assert got["phase.a"] * 1e6 == pytest.approx(5 + 10)
    assert got["phase.b"] * 1e6 == pytest.approx(5 + 10 + 10)
    assert got["phase.b.inner"] * 1e6 == pytest.approx(10)
    assert got["between"] * 1e6 == pytest.approx(20)
    assert sum(got.values()) * 1e6 == pytest.approx(120 - 30)


def test_top_ops_add_up_instantiations():
    ev = [("void (anonymous namespace)::mscan_kernel<MaxOp, false>(int)",
           0, 3), ("void (anonymous namespace)::mscan_kernel<MinOp, "
                   "true>(int)", 5, 6), ("Memcpy DtoH (Device -> Pinned)",
                                         7, 9)]
    assert tracing.top_ops(ev) == [["anon::mscan_kernel<...>", 4e-6],
                                   ["Memcpy DtoH", 2e-6]]


def test_a_chrome_trace_gives_device_events_and_its_span(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::sort", "ts": 100,
         "dur": 50},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 120, "dur": 10},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "p", "ts": 110,
         "dur": 60},
        {"ph": "i", "name": "marker", "ts": 500}]}))
    device, span = tracing.from_chrome(str(path))
    assert device == [("k", 120.0, 130.0)]
    assert span == (100.0, 170.0)


def test_wrong_jobs_count_each_layer_once_a_job():
    want = {"-Rotated.fasta": "a", "-Blocks.csv": "b", "-Blocks.bmp": "c"}
    jobs = [dict(want), dict(want, **{"-Blocks.csv": "x", "-Blocks.bmp": "y"}),
            {"-Rotated.fasta": "a", "-Blocks.csv": "b"},
            dict(want, **{"-extra.txt": "z"})]
    assert outputs.wrong_jobs(jobs, want, "R") == {
        "rotated_fasta": 0, "blocks": 2, "other": 1}
