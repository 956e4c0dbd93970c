"""BENCHMARK.json against the contract's rules that a CPU can check, and
the harness run on the CPU for a cell that a later change adds with new
files and manifest entries alone."""

import json
import os
import re

import pytest

from conftest import ROOT, TINY_CELLS
from perfbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return manifest.load_json(os.path.join(ROOT, "BENCHMARK.json"))


def test_keys_names_and_units(bench):
    assert set(bench) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[section]]
        assert len(names) == len(set(names))
        for e in bench[section]:
            assert set(e) - {"workloads"} == KEYS[section], e["name"]
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_files_found_by_name(bench):
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        cfg = manifest.load_json(os.path.join(ROOT, c["file"]))
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "data",
                                           cfg["maker"] + ".py"))
    for w in bench["workloads"]:
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "traffic",
                                           w["traffic"] + ".json"))
    for m in bench["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]))


def test_every_cell_reports_what_the_contract_asks(bench):
    for w in bench["workloads"]:
        cell = manifest.cell(w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_each_per_layer_metric_moves_a_metric_its_cells_report(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layers = {}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "kernels" in layers


def test_bounds_and_run_length(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert 1 <= bench["run_seconds"] <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (bench["run_seconds"] + 60) + cells * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_a_cell_added_as_files_runs(tiny_bench, cell):
    from perfbench import run

    result = run.run_cell(cell, 2**31 + 17, 0.5, False, device="cpu",
                          root=tiny_bench)
    assert result["correct"] and result["attempted"] >= 1
    assert set(result["metrics"]) == {
        m["name"] for m in manifest.cell(cell, tiny_bench).end_to_end}
    assert list(result)[-1] == "checks"
    json.dumps(result)


@pytest.mark.parametrize("cell,want", [
    ("tiny.align", {"front.load_ms", "align.anchors_ms", "gapdp.merge_ms",
                    "report.plot_ms"}),
    ("tiny.rotate_cli", {"startup.outside_phases_s"})])
def test_a_traced_run_reads_its_per_layer_metrics(tiny_bench, cell, want):
    from perfbench import run

    result = run.run_cell(cell, 5, 0.5, True, device="cpu",
                          root=tiny_bench)
    assert result["correct"]
    assert want <= set(result["metrics"])
    assert result["device"]["window_s"] > 0
    for key in ("device_ops", "idle_gaps"):
        assert len(result["breakdown"][key]) <= 10


def test_a_seeded_sample_of_jobs_and_the_last_are_compared(tiny_bench):
    from perfbench import run

    seed = 2**33 + 9
    result = run.run_cell("tiny.rotate", seed, 1.0, False, device="cpu",
                          root=tiny_bench)
    n = result["attempted"]
    every = manifest.cell("tiny.rotate", tiny_bench).traffic["check_every"]
    sampled = run.sample_of(seed, every)
    assert every > 1 and n > every
    assert result["compared"] == sum(sampled(i) or i == n - 1
                                     for i in range(n))
    assert result["correct"]
    again = run.sample_of(seed, every)
    assert [again(i) for i in range(64)] == [sampled(i) for i in range(64)]
    assert sum(sampled(i) for i in range(64)) == 64 // every
