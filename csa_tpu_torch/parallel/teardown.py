"""The teardown loop: two-process worlds formed and torn down one after
another, counting the processes that abort.

A pair of processes on this machine forms ``worlds_per_process`` worlds
in turn (a new port each).  In each it runs every exchange of
:class:`.sharded.Ranks` over a mesh of 4 ranks (2 a process), which
must equal the single-process ``Ranks`` on the same seeded tensors, then
:func:`.distributed.shutdown`, holding the mesh until it exits, as a
script's module-level names are: a world that a mesh still holds is the
case that used to abort at exit.  A world is aborted when one of its
processes died of a signal, and failed when one exited non-zero or ran
over its deadline, or its check did not hold::

    python -m csa_tpu_torch.parallel.teardown --worlds 12 \\
        --worlds-per-process 3          # on the card, gloo sharing it
    python -m csa_tpu_torch.parallel.teardown --device cpu --worlds 100

The last line is the summary ``summary teardown worlds=<n> aborts=<m>
wall_s=<s> ...``, with the medians of a pair's wall broken down: the
processes' start (spawn to the later one's first statement), a world's
``initialize``, exchanges and ``shutdown()`` a process, and the exit
(the later process's last statement to both reaped).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import torch

from . import distributed

_CHILD_FLAG = "--_csa-teardown-child"
WORLD_TAG = "CSA_TEARDOWN_WORLD "
END_TAG = "CSA_TEARDOWN_END "
# a child's meshes, held until its interpreter exits
_HELD: list = []


def exchanges(ranks) -> dict:
    """Every exchange of ``ranks`` on seeded tensors, as host lists: a
    list a rank (None for a rank of another process), the whole
    ``gather_to_first`` and every rank's ``item``."""
    from . import dsort

    D = ranks.size
    seeded = [torch.randint(-50, 50, (6,), generator=torch.Generator()
                            .manual_seed(100 + r)) for r in range(D)]
    xs = ranks.each(lambda r, _: seeded[r].to(ranks.devices[r]),
                    list(range(D)))
    out = {
        "ring": ranks.ppermute(xs, [(i, (i + 1) % D) for i in range(D)]),
        "xor": ranks.ppermute(xs, [(i, i ^ 1) for i in range(D)]),
        "shift": ranks.ppermute(xs, [(i + 1, i) for i in range(D - 1)]),
        "all_gather": ranks.all_gather(xs),
        "psum": ranks.psum(ranks.each(lambda r, x: x.sum(), xs)),
        "pmax": ranks.pmax(ranks.each(lambda r, x: x.max(), xs)),
    }
    first = ranks.gather_to_first(xs)
    out["scatter"] = ranks.scatter(first)
    out["replicate"] = ranks.replicate(first)
    keys = ranks.each(lambda r, x: x % 5, xs)       # heavy ties
    out["sorted_keys"], out["sorted_payloads"] = dsort.net_sort_pairs(
        ranks, keys, xs)
    ranks.finish(first)
    res = {k: [None if v is None else v.tolist() for v in vals]
           for k, vals in out.items()}
    res["gather_to_first"] = first.tolist()
    heads = ranks.each(lambda r, x: x[0], xs)
    res["item"] = [ranks.item(heads, r) for r in range(D)]
    return res


def _agrees(got: dict, want: dict, local) -> bool:
    """A process's exchanges against one process's: its own ranks'
    entries, and the whole of what every process holds."""
    for key, vals in want.items():
        if key in ("gather_to_first", "item"):
            if got[key] != vals:
                return False
            continue
        if any(got[key][r] != (vals[r] if r in local else None)
               for r in range(len(vals))):
            return False
    return True


def _threads() -> Optional[int]:
    """OS threads of this process (None where /proc does not list
    them)."""
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return None


def _child_main(argv) -> int:
    """One process of a pair: one world a port, each ending with
    shutdown() while this process still holds its mesh."""
    began = time.time()
    import weakref

    from ..utils import PROFILER
    from . import sharded

    ports, pid, device, timeout = argv[0].split(","), int(argv[1]), \
        torch.device(argv[2]), float(argv[3])
    torch.set_num_threads(1)
    if device.type == "cuda":
        torch.ones(1, device=device)      # the CUDA context's own threads
    devices = [device] if device.type == "cpu" else None
    for port in ports:
        before = _threads()
        t0 = time.perf_counter()
        distributed.initialize(f"127.0.0.1:{port}", 2, pid, device=device,
                               timeout=timeout)
        world = distributed.current()
        PROFILER.reset()
        PROFILER.enabled = True
        t1 = time.perf_counter()
        mesh = sharded.make_mesh(4, (4, 1), devices=devices)
        _HELD.append(mesh)
        got = exchanges(sharded.Ranks(mesh))
        moved = PROFILER.counters.get("rank_process_bytes", 0)
        group = weakref.ref(world.group)
        t2 = time.perf_counter()
        distributed.shutdown()
        t3 = time.perf_counter()
        after = _threads()
        print(WORLD_TAG + json.dumps({
            "exchanges": got, "local": list(mesh.local),
            "rank_process_bytes": moved, "backend": world.backend,
            "init_ms": (t1 - t0) * 1e3, "exchange_ms": (t2 - t1) * 1e3,
            "shutdown_ms": (t3 - t2) * 1e3, "group_freed": group() is None,
            "threads_left": None if before is None else after - before}),
            flush=True)
    print(END_TAG + json.dumps({"began": began, "ended": time.time()}),
          flush=True)
    return 0


def _env(root: str) -> dict:
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("CSA_TPU_COORDINATOR", "CSA_TPU_NUM_PROCESSES",
              "CSA_TPU_PROCESS_ID"):
        env.pop(k, None)
    return env


def _pair(root, n_worlds, device, timeout, visible, want) -> List[dict]:
    """One pair of processes forming ``n_worlds`` worlds, each
    process's exchanges held to ``want``; the pair's start and exit
    (seconds) go on its first world's record."""
    ports = set()
    while len(ports) < n_worlds:
        ports.add(str(distributed.free_port()))
    ports = ",".join(ports)
    argvs = [[sys.executable, "-m", "csa_tpu_torch.parallel.teardown",
              _CHILD_FLAG, ports, str(pid), device, str(timeout)]
             for pid in range(2)]
    envs = [_env(root) for _ in range(2)]
    for pid, env in enumerate(envs):
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible[pid]
    spawned = time.time()
    try:
        outs = distributed.run_processes(argvs, timeout=timeout, envs=envs)
    except TimeoutError as e:
        return [{"exit_codes": None, "ok": False, "error": str(e)}
                for _ in range(n_worlds)]
    reaped = time.time()

    def tagged(out, tag):
        return [json.loads(l[len(tag):]) for l in out.splitlines()
                if l.startswith(tag)]

    seen = [tagged(out, WORLD_TAG) for _, out, _ in outs]
    ends = [e for _, out, _ in outs for e in tagged(out, END_TAG)]
    rcs = [rc for rc, _, _ in outs]
    worlds = []
    for k in range(n_worlds):
        mine = [s[k] for s in seen if len(s) > k]
        worlds.append({
            "exit_codes": rcs,
            "ok": len(mine) == 2 and all(
                _agrees(m["exchanges"], want, m["local"])
                and m["rank_process_bytes"] > 0 for m in mine),
            "backend": mine[0]["backend"] if mine else None,
            **{key: [m[key] for m in mine] for key in
               ("init_ms", "exchange_ms", "shutdown_ms", "threads_left")},
            "group_freed": all(m["group_freed"] for m in mine),
            "error": "; ".join(err[-1500:] for rc, _, err in outs if rc)})
    if len(ends) == 2:
        worlds[0]["start_s"] = max(e["began"] for e in ends) - spawned
        worlds[0]["exit_s"] = reaped - max(e["ended"] for e in ends)
    return worlds


def run_teardown_loop(worlds: int = 10, *, device: str = "cuda",
                      worlds_per_process: int = 1, timeout: float = 300,
                      visible: Optional[Sequence[str]] = None) -> dict:
    """Form and tear down ``worlds`` two-process worlds on ``device``'s
    type, one after another, ``worlds_per_process`` to a pair of
    processes.  Returns the counts (``aborts``: worlds in which a
    process died of a signal; ``failed``: worlds with any non-zero exit,
    a deadline run over or a check that did not hold) and every world's
    record.  ``visible`` gives each process its ``CUDA_VISIBLE_DEVICES``
    (default: both see every card, so they share one over gloo).
    ``device="cuda"`` without a CUDA device raises."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_teardown_loop: no CUDA device is available "
                           "(pass device='cpu' to run on the CPU)")
    from . import sharded

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    # one process's exchanges on 4 CPU ranks (host values: the same on
    # any device)
    want = exchanges(sharded.Ranks(sharded.make_mesh(
        4, (4, 1), devices=[torch.device("cpu")])))
    records = []
    t0 = time.perf_counter()
    while len(records) < worlds:
        t = time.perf_counter()
        n = min(worlds_per_process, worlds - len(records))
        got = _pair(root, n, device, timeout, visible, want)
        for rec in got:
            rec["wall_s"] = (time.perf_counter() - t) / len(got)
        records += got
    wall = time.perf_counter() - t0
    aborted = [k for k, r in enumerate(records)
               if r["exit_codes"] and any(rc < 0 for rc in r["exit_codes"])]
    failed = [k for k, r in enumerate(records)
              if not r["ok"] or not r["exit_codes"] or any(r["exit_codes"])]
    return {"device": device, "worlds": len(records), "aborts": len(aborted),
            "failed": len(failed), "aborted_worlds": aborted,
            "failed_worlds": failed, "wall_s": wall, "records": records}


def _median(xs) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def summary_line(res: dict) -> str:
    """``summary teardown worlds=<n> aborts=<m> wall_s=<s> ...``, with
    the medians of the breakdown where the worlds recorded it."""
    line = (f"summary teardown worlds={res['worlds']} aborts={res['aborts']}"
            f" wall_s={res['wall_s']:.3f} failed={res['failed']} "
            f"device={res['device']}")
    for key in ("start_s", "init_ms", "exchange_ms", "shutdown_ms",
                "exit_s"):
        xs = [x for r in res["records"] for x in
              (r[key] if isinstance(r.get(key), list) else [r.get(key)])
              if x is not None]
        if xs:
            line += f" {key}_median={_median(xs):.3f}"
    left = [t for r in res["records"] for t in r.get("threads_left", [])
            if t is not None]
    if left:
        line += f" threads_left_max={max(left)}"
    return line


if __name__ == "__main__":
    # run as the package's module (the children read its world), not as
    # a second copy of it named __main__
    from csa_tpu_torch.parallel import teardown as _self

    if len(sys.argv) > 1 and sys.argv[1] == _CHILD_FLAG:
        sys.exit(_self._child_main(sys.argv[2:]))
    parser = argparse.ArgumentParser(
        description="form and tear down two-process worlds, counting "
                    "aborts")
    parser.add_argument("--worlds", type=int, default=10)
    parser.add_argument("--device", default="cuda",
                        help="torch device type of the ranks (default cuda)")
    parser.add_argument("--worlds-per-process", type=int, default=1)
    a = parser.parse_args()
    result = _self.run_teardown_loop(
        a.worlds, device=a.device, worlds_per_process=a.worlds_per_process)
    print(_self.summary_line(result), flush=True)
    sys.exit(0 if result["aborts"] == 0 and result["failed"] == 0 else 1)
