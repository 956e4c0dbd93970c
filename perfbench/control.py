#!/usr/bin/env python3
"""The control of a cell at its own size: the plain reference with one
guarantee of the configuration broken (the traffic file's ``control``),
put in the program's place and judged as a run judges the program.

    python3 perfbench/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the cell's input, works the outputs out with the
reference and with the control, and prints one JSON line: the numbers a
run compares (jobs whose files of each kind differ; limit 0) and whether
they would make the run not correct.  The benchmark's own runs never run
this; it needs no card.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import manifest, outputs  # noqa: E402
from perfbench.run import reference_digests  # noqa: E402


def one_seed(name, seed, control, root=manifest.ROOT):
    """(want, got) digests of the reference and of ``control`` (None: the
    reference itself) for ``seed``."""
    cell = manifest.cell(name, root)
    work = tempfile.mkdtemp(prefix="perfbench-control-")
    try:
        inp = os.path.join(work, "input.txt")
        manifest.maker(cell.config, root).make(cell.config["params"], seed,
                                               inp)
        return reference_digests(cell.traffic["mode"], inp, work,
                                 control=control)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    cell = manifest.cell(args.workload)
    control = cell.traffic["control"]
    mode = cell.traffic["mode"]
    tasks = [(s, c) for s in args.seeds for c in (None, control)]
    # mode R works the seeds side by side; mode N already spreads one
    # seed's merges over processes
    workers = min(len(tasks), os.cpu_count() or 1)
    if mode == "R" and workers > 1:
        ctx = multiprocessing.get_context("spawn")
        with concurrent.futures.ProcessPoolExecutor(
                workers, mp_context=ctx) as pool:
            done = list(pool.map(one_seed, [args.workload] * len(tasks),
                                 *zip(*tasks)))
    else:
        done = [one_seed(args.workload, s, c) for s, c in tasks]
    got = dict(zip(tasks, done))
    for seed in args.seeds:
        wrong = outputs.wrong_jobs([got[seed, control]], got[seed, None],
                                   mode)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": control, "wrong_jobs": wrong,
                          "not_correct": any(wrong.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
