"""What a process pays for the rotation block stage and the anchors'
linear sort on each route, measured in fresh processes.

The port's CLI is one process a job (the web frontend starts one a job
too), so its first call of :func:`engine.rotation_final` and of
:func:`engine.linear_suffix_order` is the one a user waits for.
:func:`measure` starts one process for each (tree, set, route) and
times, inside it, the first calls of both functions and the calls after
them; it also runs the CLI in fresh processes and reads its ``--profile``
phases.  The routes:

* ``staged``: ``engine.rotation_final_staged`` at every call and the
  linear sort's gate ``FUSED_MAX_CHARS`` at 0: the staged loops (one
  host read a refinement level);
* ``fused``: ``engine._rotation_final_fused`` at every call (a key's
  first call captures) and the linear gate above every set, the fused
  programs as the tree runs them through :func:`graphs.run`;
* ``eager``: the fused programs run plainly on the device at every call
  (no graph), the cost of the static program itself;
* ``native``: the CLI's ``--backend native`` (CLI runs only).

Every route's output must equal the others' (``AssertionError``
otherwise).  ``roots`` are checkouts to measure side by side; each child
imports ``csa_tpu_torch`` from its root.  Sizes are arguments, so a CPU
test runs it small.

    python -m csa_tpu_torch.index.fused_walls      # one JSON line, on cuda
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FIX = ROOT / "tests" / "fixtures"

# (name, length, sequences) of a synthetic set from the scaling module's
# generator (seed 7), or a fixture's name alone
SETS = [("s4x16k", 16_000, 4), ("Primates",), ("Set3",),
        ("s8x50k", 50_000, 8), ("s8x200k", 200_000, 8),
        ("s8x500k", 500_000, 8)]
# above the fused gate: the staged stage's size in the rotation measurement
MORE_SETS = [("s8x1M", 1_000_000, 8)]
ROUTES = ("staged", "fused", "eager")
GATE_ON = 1 << 62

# the part of a child that picks its route: imported from its root
_ROUTE = """
import json, sys, time
a = json.loads(sys.argv[1])
from csa_tpu_torch.index import engine, graphs
runs = []
_run = graphs.run
def _spy(key, program, inputs, device):
    runs.append(key)
    if a["route"] == "eager":
        return program(*(x.to(device) for x in inputs)).cpu().numpy()
    return _run(key, program, inputs, device)
graphs.run = _spy
_block = (engine.rotation_final_staged if a["route"] == "staged"
          else engine._rotation_final_fused)
def _rotation_final(encoded, device, *, pack_w=12, mesh=None):
    return _block(encoded, device, pack_w=pack_w)
engine.rotation_final = _rotation_final
engine.FUSED_MAX_CHARS = 0 if a["route"] == "staged" else a["gate"]
"""

# a child timing the two functions: the block stage's calls, then the
# linear sort's (the CLI's order); a fused child then drops its graphs
# and calls once more (a capture with every guess cached)
_CALLS = _ROUTE + """
import hashlib
import numpy as np
import torch
from csa_tpu_torch.index.fused_walls import anchor_string, load_set
dev = torch.device(a["device"])
if dev.type == "cuda":
    torch.zeros(1, device=dev)
    torch.cuda.synchronize(dev)
enc = load_set(a["set"])
s = anchor_string(enc)

def timed(fn):
    del runs[:]
    t0 = time.perf_counter()
    res = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3, len(runs), res

def digest(arrays):
    h = hashlib.sha1()
    for x in arrays:
        h.update(np.ascontiguousarray(np.asarray(x, dtype=np.int64)))
    return h.hexdigest()

out = {}
for tag, fn in (("block", lambda: engine.rotation_final(enc, dev)),
                ("linear", lambda: engine.linear_suffix_order(s, dev))):
    walls, progs = [], []
    for _ in range(a["calls"]):
        ms, n, res = timed(fn)
        walls.append(ms)
        progs.append(n)
    if a["route"] == "fused" and dev.type == "cuda":
        graphs.clear()
        ms, n, res = timed(fn)
        out[tag + "_recapture_ms"] = ms
    out[tag + "_ms"] = walls
    out[tag + "_programs"] = progs
    if tag == "block":
        out["block_digest"] = digest(
            [[res.num_collected, res.num_after_suffix], res.final_start,
             res.final_depth, res.final_positions])
    else:
        out["linear_digest"] = digest(res)
out["captures"] = graphs.STATS["captures"]
out["replays"] = graphs.STATS["replays"]
print("RESULT " + json.dumps(out))
"""

# a child running the CLI on its route
_CLI = _ROUTE + """
from csa_tpu_torch import cli
sys.exit(cli.main(a["argv"]))
"""


def load_set(spec):
    """The encoded sequences of a set spec (see :data:`SETS`)."""
    import io

    import numpy as np

    if len(spec) == 1:
        from ..io import fasta

        return fasta.load_fasta(str(FIX / f"{spec[0]}.txt"),
                                log=io.StringIO()).encoded_all()
    from ..parallel.scaling import _synthetic_set

    return [np.asarray(r) for r in _synthetic_set(spec[2], spec[1], 7)]


def anchor_string(enc):
    """The anchors' linear string of a set (``align/anchors.py``): each
    sequence above the k separators, followed by its own separator."""
    import numpy as np

    k = len(enc)
    return np.concatenate([np.append(np.asarray(e, dtype=np.int64) + k, i)
                           for i, e in enumerate(enc)])


def _child(root: Path, code: str, args: dict, cwd: Path, timeout: float):
    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(args)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"child {args} in {root} returned "
                           f"{proc.returncode}: {proc.stderr[-3000:]}")
    return proc.stdout, wall


def _phases(text: str):
    out = {}
    for line in text.splitlines():
        if line.startswith(">   ") and not line.startswith(">   TOTAL"):
            parts = line.split()
            out[parts[1]] = float(parts[2].rstrip("s"))
    return out


def _turns(items, reps: int):
    """``items`` forwards then backwards, ``reps`` times in all (A B B A
    ...), so that a drift of the host touches every item alike."""
    order = []
    for r in range(reps):
        order += items if r % 2 == 0 else items[::-1]
    return order


def call_walls(roots, sets, routes, device, reps, calls, timeout=900):
    """{root: {set: {route: [child result, ...]}}} of fresh processes,
    each timing ``calls`` calls of both functions on one set."""
    out = {str(r): {} for r in roots}
    with tempfile.TemporaryDirectory() as tmp:
        for spec in sets:
            plan = [(r, route) for r in roots for route in routes]
            for root, route in _turns(plan, reps):
                text, _ = _child(root, _CALLS, {
                    "route": route, "gate": GATE_ON, "device": device,
                    "set": list(spec), "calls": calls}, Path(tmp), timeout)
                res = json.loads(text.split("RESULT ", 1)[1])
                out[str(root)].setdefault(spec[0], {}).setdefault(
                    route, []).append(res)
    for spec in sets:
        for tag in ("block_digest", "linear_digest"):
            seen = {res[tag] for per in out.values()
                    for rs in per[spec[0]].values() for res in rs}
            assert len(seen) == 1, f"{spec[0]}: the routes' {tag} differ"
    return out


def _mode_input(mode: str, spec, tmp: Path):
    """(argv file, output files) of a CLI run of ``mode`` on ``spec``."""
    import numpy as np

    if len(spec) == 1:
        src = FIX / (f"{spec[0]}-Rotated.fasta" if mode == "A"
                     else f"{spec[0]}.txt")
        text = src.read_bytes()
    else:
        letters = np.frombuffer(b"ACGT", dtype=np.uint8)
        text = "".join(f">s{i}\n{letters[row].tobytes().decode()}\n"
                       for i, row in enumerate(load_set(spec))).encode()
    name = spec[0].rsplit("/", 1)[-1]
    arg = f"{name}-Rotated.fasta" if mode == "A" else f"{name}.txt"
    (tmp / arg).write_bytes(text)
    stem = arg.rsplit(".", 1)[0]
    outs = [f"{stem}-Aligned.fasta"] if mode == "A" else \
        [f"{name}-Rotated.fasta"] + ([f"{name}-Aligned.fasta"]
                                     if mode == "N" else [])
    return arg, outs


def _aligned_rows(data: bytes):
    return [l for l in data.decode().splitlines() if not l.startswith(">")]


def cli_walls(roots, runs, device, reps, timeout=900):
    """{root: {"MODE set": {route: [{"wall_s", "phases"}, ...]}}} of the
    CLI in fresh processes; ``runs`` holds (mode, set spec, routes)."""
    out = {str(r): {} for r in roots}
    for mode, spec, routes in runs:
        label = f"{mode} {spec[0]}"
        got = {}
        plan = [(r, route) for r in roots for route in routes]
        for root, route in _turns(plan, reps):
            with tempfile.TemporaryDirectory() as tmp:
                tmp = Path(tmp)
                arg, outs = _mode_input(mode, spec, tmp)
                argv = ([] if mode == "N" else [mode]) + [
                    arg, "--profile", "--device", device]
                if route == "native":
                    argv += ["--backend", "native"]
                text, wall = _child(root, _CLI, {
                    "route": "fused" if route == "native" else route,
                    "gate": GATE_ON, "argv": argv}, tmp, timeout)
                files = [(tmp / o).read_bytes() for o in outs]
            key = [files[0] if mode != "A" else _aligned_rows(files[0])]
            if mode == "N":
                key.append(_aligned_rows(files[1]))
            got.setdefault(json.dumps([str(x) for x in key]), []).append(
                (str(root), route))
            out[str(root)].setdefault(label, {}).setdefault(
                route, []).append({"wall_s": wall, "phases": _phases(text)})
        assert len(got) == 1, f"{label}: the routes' output differs: " \
                              f"{list(got.values())}"
    return out


def _default_cli(sets, routes):
    """Mode R on every set with ``native`` too, modes N and A on
    Primates and Set3."""
    runs = [("R", spec, list(routes) + ["native"]) for spec in sets]
    return runs + [(m, (n,), list(routes)) for m in ("N", "A")
                   for n in ("Primates", "Set3")]


def measure(roots=(ROOT,), sets=SETS, routes=ROUTES, device="cuda",
            reps=2, calls=4, cli_runs=None, timeout=900):
    """One dict: the card (``nvidia-smi`` name and power limit on cuda),
    :func:`call_walls` and :func:`cli_walls` (default:
    :func:`_default_cli`)."""
    roots = [Path(r).resolve() for r in roots]
    if cli_runs is None:
        cli_runs = _default_cli(sets, routes)
    card = "cpu"
    if device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    calls_out = call_walls(roots, sets, routes, device, reps, calls, timeout)
    cli_out = cli_walls(roots, cli_runs, device, reps, timeout)
    return {"card": card, "roots": [str(r) for r in roots],
            "calls": calls_out, "cli": cli_out,
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--roots", nargs="*", default=[str(ROOT)])
    p.add_argument("--reps", type=int, default=2)
    p.add_argument("--calls", type=int, default=4)
    p.add_argument("--sets", nargs="*",
                   help="names from SETS or MORE_SETS (default: SETS)")
    p.add_argument("--routes", nargs="*", default=list(ROUTES))
    p.add_argument("--no-calls", action="store_true",
                   help="only the CLI runs")
    p.add_argument("--no-cli", action="store_true",
                   help="only the fresh-process function calls")
    p.add_argument("--out", help="also write the JSON to this file")
    args = p.parse_args(argv)
    sets = [s for s in SETS + MORE_SETS
            if (s[0] in args.sets if args.sets else s in SETS)]
    res = measure(args.roots, [] if args.no_calls else sets,
                  routes=args.routes, device=args.device, reps=args.reps,
                  calls=args.calls,
                  cli_runs=[] if args.no_cli else _default_cli(
                      sets, args.routes))
    line = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
