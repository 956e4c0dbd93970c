"""The benchmark's CPU tests: ``python -m pytest -q perfbench/tests``
from the repository's root.  They import the benchmark as the
``perfbench`` package from the root, and drive the harness on the CPU
with ``device="cpu"`` (the program's plain versions)."""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FIX = os.path.join(ROOT, "tests", "fixtures")
TINY_CELLS = {"tiny.align": "align", "tiny.rotate": "rotate",
              "tiny.rotate_cli": "rotate_cli"}


def copy_bench(dst):
    """BENCHMARK.json and the benchmark's files, as a checkout holds
    them, under ``dst``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(dst, "perfbench"),
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))


def add_tiny(root, fasta="a-diverge-1.txt"):
    """Add a configuration ``tiny`` (a small set of the C tool's
    fixtures, turned by the seed) and its cells to a copy, as a later
    change would: new files and new manifest entries only."""
    shutil.copy(os.path.join(FIX, "tiny", fasta),
                os.path.join(root, "perfbench", "data", "tiny.txt"))
    with open(os.path.join(root, "perfbench", "configs", "tiny.json"),
              "w") as f:
        json.dump({"maker": "rotated_fasta", "params": {"file": "tiny.txt"},
                   "reduced": []}, f)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "tests/fixtures/tiny",
                             "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for name, traffic in TINY_CELLS.items():
        bench["workloads"].append({"name": name, "config": "tiny",
                                   "traffic": traffic, "chips": 1,
                                   "why": "CPU tests"})
    like = {"tiny.align": "primates.align", "tiny.rotate": "primates.rotate",
            "tiny.rotate_cli": "primates.rotate_cli"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [t for t, p in like.items()
                               if p in m["workloads"]]
    with open(path, "w") as f:
        json.dump(bench, f, indent=1)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: a full-size check of minutes and GiBs; it runs "
        "only when asked for by name (-m slow)")


def pytest_collection_modifyitems(config, items):
    if "slow" in (config.getoption("markexpr") or "").split():
        return
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(pytest.mark.skip(
                reason="full size: run it with -m slow"))


@pytest.fixture
def tiny_bench(tmp_path):
    """A copy of the benchmark with the ``tiny`` cells added."""
    copy_bench(str(tmp_path))
    add_tiny(str(tmp_path))
    return str(tmp_path)
