"""What ``BENCHMARK.json`` names, found by name in the benchmark's folder.

* a cell (``workloads`` entry) names a configuration and a traffic mix;
* a configuration is ``configs/<name>.json`` (its ``file``): the source,
  what was cut and assumed, the guarantees, and the data maker
  ``data/<maker>.py`` with its parameters;
* a traffic mix is ``traffic/<name>.json``: the CLI mode, the runner
  (``warm``: jobs one after another in this process; ``cli``: each job
  a fresh ``python -m csa_tpu_torch.cli`` child), extra CLI flags, the
  control that breaks the mix's guarantee and ``check_every``, the
  stride of the seeded sample of jobs whose outputs are compared;
* a per-layer metric is ``metrics/<name>.py`` with ``read(run)``.

A cell reports every end-to-end metric that lists it under
``workloads`` (or lists no cells) and every per-layer metric that lists
it, or that lists no cells and moves a metric the cell reports.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclass
class Cell:
    name: str
    chips: int
    config: dict  # the configuration's file, with its manifest entry
    traffic: dict  # the traffic file, with its name
    end_to_end: list  # manifest entries of the metrics this cell reports
    per_layer: list


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    work = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == work["config"])
    config = dict(load_json(os.path.join(root, entry["file"])), **entry)
    traffic = dict(load_json(os.path.join(
        root, "perfbench", "traffic", work["traffic"] + ".json")),
        name=work["traffic"])
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [])
                 or ("workloads" not in m and m["moves"] in reported)]
    return Cell(name, int(work["chips"]), config, traffic, e2e, per_layer)


def _load_file(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def maker(config: dict, root: str = ROOT):
    """The data maker module ``data/<maker>.py`` of a configuration."""
    return _load_file(os.path.join(root, "perfbench", "data",
                                   config["maker"] + ".py"),
                      "perfbench_maker_" + config["maker"])


def metric_reader(name: str, root: str = ROOT):
    """``read(run)`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    return _load_file(path, "perfbench_metric_" + name.replace(".", "_")).read
