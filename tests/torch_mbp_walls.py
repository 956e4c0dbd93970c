"""Fresh-process walls of the port's CLI at csa_tpu's two Mbp
configurations: the full pipeline on 8 x 1 Mbp (seed 7) and mode R on
4 x 5 Mbp (seed 13), on ``--backend device`` and ``native`` in turns
(device, native, native, device), each with ``--profile`` in a fresh
process under a wrapper whose ``RUSAGE_CHILDREN`` gives the run's peak
RSS (as bench.py's Mbp run takes it).  Every run's output is held to
csa_tpu's (``chip_smoke.MBP_*``).  Run from the root of a checkout, on a
machine with a card, once the kernels and the native host library are
built (the script builds both first)::

    python tests/torch_mbp_walls.py --out mbp_walls.json

One line a run, ``mbp_wall <config> <route> wall_s=... rss_gib=...
card_gib=...``, then a line a configuration and route with the median
and range of its walls; ``--out`` also keeps every run's stage table,
counters and launch counts.  ``--configs full`` (or ``r5``) and
``--order device,native`` cut it; ``--order csa_tpu`` times the JAX
package's native host engine (``python -m csa_tpu.cli --backend
native``, no JAX imported) on the same sets."""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# the wrapper: one child, its wall and its peak RSS
WRAP = """
import resource, subprocess, sys, time
t0 = time.perf_counter()
rc = subprocess.call(sys.argv[1:])
wall = time.perf_counter() - t0
ru = resource.getrusage(resource.RUSAGE_CHILDREN)
print(f"MBP_WRAP {rc} {wall} {ru.ru_maxrss}")
sys.exit(rc)
"""
# the child: the port's CLI, then its launch counts, the card's peak and
# the process's peak RSS once its modules were imported
CHILD = """
import json, resource, sys
import torch
from csa_tpu_torch import cli, kernels
import_rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
rc = cli.main(sys.argv[1:])
peak = torch.cuda.max_memory_allocated() if torch.cuda.is_initialized() else 0
print("MBP_CHILD " + json.dumps({"launches": kernels.COUNTS,
                                 "cuda_peak_bytes": peak,
                                 "import_rss_bytes": import_rss}))
sys.exit(rc)
"""
# configuration -> (file name, _write_mbp arguments, CLI mode arguments,
# the check of its output against csa_tpu's)
CONFIGS = {
    "full": ("mbp.txt", chip_smoke.MBP_FULL_SET, [],
             chip_smoke.check_mbp_full),
    "r5": ("mbp5.txt", chip_smoke.MBP5_SET, ["R"], chip_smoke.check_mbp5),
}


def one_run(config: str, route: str, src: Path, timeout: float) -> dict:
    """One fresh process of ``config`` on ``route``: the port's CLI on
    that ``--backend``, or for "csa_tpu" the JAX package's native host
    engine (``python -m csa_tpu.cli --backend native``, which imports
    no JAX), the yardstick of PERF.md section 2."""
    name, _, mode, check_output = CONFIGS[config]
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        shutil.copy(src, work / name)
        if route == "csa_tpu":
            cmd = ["-m", "csa_tpu.cli", *mode, name, "--backend", "native"]
        else:
            cmd = ["-c", CHILD, *mode, name, "--backend", route]
        argv = [sys.executable, "-c", WRAP, sys.executable, *cmd,
                "--profile"]
        proc = subprocess.run(
            argv, cwd=work, capture_output=True, text=True, timeout=timeout,
            env={**os.environ, "PYTHONPATH": str(ROOT)})
        text = proc.stdout
        chip_smoke.check(proc.returncode == 0 and "> Done!" in text,
                         f"{config} {route} returned {proc.returncode}: "
                         f"{proc.stderr[-3000:]}")
        check_output(work, text)
    wrap = [l for l in text.splitlines() if l.startswith("MBP_WRAP ")][0]
    _, _, wall, rss_kb = wrap.split()
    child = {"launches": {}, "cuda_peak_bytes": 0, "import_rss_bytes": None}
    for line in text.splitlines():
        if line.startswith("MBP_CHILD "):
            child = json.loads(line[len("MBP_CHILD "):])
    phases, counters = chip_smoke.profile_table(text)
    return {"config": config, "route": route, "wall_s": float(wall),
            "peak_rss_bytes": int(rss_kb) * 1024, **child,
            "phases_s": phases, "counters": counters}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--configs", default="full,r5")
    parser.add_argument("--order", default="device,native,native,device")
    parser.add_argument("--timeout", type=float, default=1800)
    parser.add_argument("--out", default=None)
    a = parser.parse_args()
    from csa_tpu_torch import kernels, native

    chip_smoke.check(native.available(),
                     "the port's native host library did not build")
    kernels.build()
    kernels.load()
    card = chip_smoke.smi_line()
    print(card, flush=True)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for config in a.configs.split(","):
            name, spec, _, _ = CONFIGS[config]
            src = Path(tmp) / name
            chip_smoke._write_mbp(src, *spec)
            for route in a.order.split(","):
                t0 = time.perf_counter()
                rec = one_run(config, route, src, a.timeout)
                rec["outer_wall_s"] = time.perf_counter() - t0
                runs.append(rec)
                print(f"mbp_wall {config} {route} wall_s={rec['wall_s']:.3f}"
                      f" rss_gib={rec['peak_rss_bytes'] / 2**30:.3f} "
                      f"card_gib={rec['cuda_peak_bytes'] / 2**30:.3f} "
                      f"import_rss_bytes={rec['import_rss_bytes']} "
                      f"launches={rec['launches']} "
                      f"phases={json.dumps(rec['phases_s'])} "
                      f"counters={json.dumps(rec['counters'])}", flush=True)
    summary = {}
    for rec in runs:
        key = f"{rec['config']} {rec['route']}"
        summary.setdefault(key, []).append(rec["wall_s"])
    for key, walls in summary.items():
        print(f"summary mbp_walls {key} ({card}): median "
              f"{statistics.median(walls):.3f} s, range {min(walls):.3f}-"
              f"{max(walls):.3f} s over {len(walls)} runs", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps({"card": card, "runs": runs},
                                          indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
