"""Multi-process launch (counterpart of :mod:`csa_tpu.parallel.distributed`).

Each process runs the same CLI with a coordinator address;
:func:`initialize` forms the world with ``torch.distributed``, and every
mesh that :func:`.sharded.make_mesh` builds afterwards spans the ranks
of every process: process p owns a contiguous block of them, and the
exchanges between ranks of different processes become
``torch.distributed`` calls (:class:`.sharded.Ranks`).

    # on every process p of N (one machine or several):
    python -m csa_tpu_torch.cli R input.fasta --backend sharded \\
        --mesh 8x1 --coordinator host0:8476 --num-processes N \\
        --process-id p

The flags have the environment equivalents that ``csa_tpu`` reads,
``CSA_TPU_COORDINATOR``, ``CSA_TPU_NUM_PROCESSES`` and
``CSA_TPU_PROCESS_ID``, so one launch line serves both packages.  JAX's
TPU-pod auto-detection (``TPU_WORKER_HOSTNAMES``) has no GPU
counterpart: without a coordinator a process runs alone.

The backend of the exchanges is decided once, from the layout.  The
world forms over gloo (``init_process_group`` on ``tcp://HOST:PORT``),
each process names the cards it sees by UUID, and the exchanges run on
a second group:

* NCCL when every process drives CUDA ranks on cards that no other
  process sees; a process's exchanges run on its first card;
* gloo for CPU ranks, and for processes that share a card (NCCL refuses
  two processes on one device); CUDA tensors pass through host memory.

An NCCL failure raises: nothing retries over gloo, and nothing drops
back to one process.  Every group has a finite timeout.

:func:`shutdown` ends a world as ``jax.distributed.shutdown()`` does: it
waits for every process at a barrier before anything is destroyed, and
it frees the groups (joining their worker threads) before it returns.

:func:`run_multiprocess_dryrun` proves the cross-process paths on one
machine: it spawns N real OS processes, each driving its own ranks,
forms the world over localhost, and runs the sharded rotation stage and
the rank-split gap DP over one global mesh against the single-process
results.
"""

from __future__ import annotations

import datetime
import gc
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import weakref
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# seconds a process waits for the others to join or to reach a call
DEFAULT_TIMEOUT_S = 600


@dataclass(eq=False)
class World:
    """The processes of a multi-process run, as this process sees them.
    Meshes hold it; :func:`shutdown` lets go of ``group``."""
    rank: int            # this process
    size: int            # processes
    backend: str         # of the exchanges: "nccl" or "gloo"
    group: object = field(repr=False)   # the group they run on


_WORLD: Optional[World] = None


def current() -> Optional[World]:
    """The world :func:`initialize` formed, or None (one process)."""
    return _WORLD


def _cards() -> List[str]:
    """UUIDs of the CUDA devices this process sees."""
    return [str(torch.cuda.get_device_properties(k).uuid)
            for k in range(torch.cuda.device_count())]


def _backend(device: torch.device, size: int) -> str:
    """NCCL when every process sees CUDA cards that no other process
    sees, else gloo (gathered over the world's gloo group)."""
    if device.type != "cuda":
        return "gloo"
    seen: list = [None] * size
    dist.all_gather_object(seen, _cards())
    flat = [u for cards in seen for u in cards]
    return "nccl" if flat and len(flat) == len(set(flat)) else "gloo"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cpu",
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Form the world from flags or the ``CSA_TPU_*`` environment; True
    when it holds more than one process.  Without a coordinator it
    touches nothing and returns False.  ``device`` is the type the
    process's ranks run on, which decides the backend."""
    global _WORLD
    coordinator = coordinator or os.environ.get("CSA_TPU_COORDINATOR")
    if num_processes is None:
        env = os.environ.get("CSA_TPU_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("CSA_TPU_PROCESS_ID")
        process_id = int(env) if env else None
    if not coordinator:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the process count and this "
                         "process's id (--num-processes, --process-id)")
    wait = datetime.timedelta(seconds=timeout)
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id), timeout=wait)
    size, rank = dist.get_world_size(), dist.get_rank()
    if size == 1:
        dist.destroy_process_group()
        return False
    backend = _backend(torch.device(device), size)
    group = dist.group.WORLD
    if backend == "nccl":
        torch.cuda.set_device(0)
        group = dist.new_group(backend="nccl", timeout=wait)
        # the first call forms the communicator (and must be collective
        # before any send or receive); a failure raises here
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe, group=group)
        if int(probe) != size:
            raise RuntimeError(f"NCCL all_reduce over {size} processes "
                               f"gave {int(probe)}")
    _WORLD = World(rank, size, backend, group)
    return True


def shutdown(wait: bool = True) -> None:
    """Tear the world down; a no-op without one.

    With ``wait``, every process meets the others at a barrier over the
    world's gloo group before anything is destroyed (none is still in an
    exchange).  The NCCL group goes before the world it rides on.
    Either way every group is freed before this returns, which joins its
    worker threads: ``destroy_process_group`` only unregisters a group,
    and a gloo worker thread still alive when the interpreter finalises
    aborts the process ("terminate called without an active exception")
    as it drops a finished exchange's tensors.  A process that fails
    passes ``wait=False``: its peers, stuck in an exchange it will not
    join, see it leave at once instead of at their timeout."""
    global _WORLD
    world, _WORLD = _WORLD, None
    if not (dist.is_available() and dist.is_initialized()):
        return
    if wait:
        if world is not None and world.backend == "nccl":
            torch.cuda.synchronize()
        dist.barrier()
    groups = [weakref.ref(dist.group.WORLD)]
    if world is not None:
        group, world.group = world.group, None
        if group is not dist.group.WORLD:
            groups.append(weakref.ref(group))
            dist.destroy_process_group(group)
        del group
    dist.destroy_process_group()
    if any(g() is not None for g in groups):
        gc.collect()       # a cycle (a traceback's frames) may hold one
    if wait and any(g() is not None for g in groups):
        raise RuntimeError("shutdown: a process group outlives "
                           "destroy_process_group (something still holds "
                           "it), so its worker threads outlive it too")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argvs: Sequence[Sequence[str]], *, timeout: float,
                  cwds: Optional[Sequence] = None,
                  envs: Optional[Sequence[dict]] = None
                  ) -> List[Tuple[int, str, str]]:
    """Start one process an argv, all at once, and wait for every one;
    returns ``(returncode, stdout, stderr)`` a process.  Their output
    goes to files, so that no process stalls on a full pipe while the
    others wait for it in a call.  When ``timeout`` seconds pass, every
    process still running is killed and TimeoutError is raised."""
    n = len(argvs)
    with tempfile.TemporaryDirectory() as logs:
        procs, files = [], []
        try:
            for k, argv in enumerate(argvs):
                out = open(os.path.join(logs, f"{k}.out"), "w+")
                err = open(os.path.join(logs, f"{k}.err"), "w+")
                files.append((out, err))
                procs.append(subprocess.Popen(
                    list(argv), stdout=out, stderr=err,
                    cwd=None if cwds is None else cwds[k],
                    env=None if envs is None else envs[k]))
            deadline = time.monotonic() + timeout
            for p in procs:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise TimeoutError(
                        f"{n} processes ran over {timeout:g} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            results = []
            for p, (out, err) in zip(procs, files):
                out.seek(0)
                err.seek(0)
                results.append((p.returncode, out.read(), err.read()))
                out.close()
                err.close()
    return results


# ---------------------------------------------------------------------------
# the multi-process dryrun

_CHILD_FLAG = "--_csa-multihost-child"
RESULT_TAG = "CSA_MULTIHOST_RESULT "


def dryrun_set() -> List:
    """The dryrun's circular set, as ``csa_tpu``'s dryrun makes it: 8
    sequences of 1,500, rotated copies of one core with 12 changes
    each."""
    import numpy as np

    rng = np.random.default_rng(5)
    base = rng.integers(0, 4, size=1500, dtype=np.int64)
    encoded = []
    for _ in range(8):
        row = np.roll(base, int(rng.integers(0, 1500))).copy()
        idx = rng.integers(0, 1500, size=12)
        row[idx] = rng.integers(0, 4, size=12)
        encoded.append(row)
    return encoded


def dryrun_items(n_items: int) -> List[tuple]:
    """The dryrun's gap DP batch, as ``csa_tpu``'s dryrun makes it."""
    import numpy as np

    from ..align import progressive

    rng = np.random.default_rng(9)
    items = []
    for _ in range(n_items):
        R = int(rng.integers(30, 160))
        C = int(rng.integers(30, 160))
        i = int(rng.integers(1, 5))
        cds = rng.integers(0, 4, size=R).astype(np.int8)
        sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
        top = progressive.default_top_row(sv, i)
        items.append((cds, sv, i, top, -i))
    return items


def _child_main(argv) -> int:
    """One dryrun process: its ranks of the global mesh."""
    port, nproc, pid, per_proc, device, timeout = argv[:6]
    import numpy as np

    from ..index import cyclic, engine
    from ..dp import profile
    from ..utils import PROFILER
    from . import sharded

    torch.set_num_threads(1)
    device = torch.device(device)
    initialize(f"127.0.0.1:{port}", int(nproc), int(pid), device=device,
               timeout=float(timeout))
    world = current()
    n_ranks = int(nproc) * int(per_proc)
    mesh = sharded.make_mesh(n_ranks, (n_ranks, 1),
                             devices=[device] if device.type == "cpu"
                             else None)
    home = mesh.home
    PROFILER.enabled = True
    encoded = dryrun_set()

    # leg 1: the ladder and the rank-local front over ranks of every
    # process against this process's single-device stage
    fin = engine.rotation_final(encoded, home, mesh=mesh)
    moved = dict(PROFILER.counters)
    single = engine.rotation_final(encoded, home)
    fields = ("num_collected", "num_after_suffix", "final_start",
              "final_depth", "final_positions")
    ladder_ok = fin is not None and single is not None and all(
        np.array_equal(getattr(fin, f), getattr(single, f)) for f in fields)

    # leg 2: the final blocks against the numpy cyclic engine (the
    # cascade pipeline.analyze runs on the host path)
    index = cyclic.build_rotation_index(encoded)
    bs = cyclic.collect_blocks(index)
    keep = cyclic.remove_suffix_blocks(bs)
    unique, positions = bs.positions_if_unique()
    wmask = keep & unique
    want = {(int(d), tuple(int(x) for x in p))
            for d, p in zip(bs.depth[wmask], positions[wmask])}
    got = None if fin is None else {
        (int(d), tuple(int(x) for x in p))
        for d, p in zip(fin.final_depth, fin.final_positions)}
    blocks_ok = got == want

    # leg 3: the batched gap DP over the ranks of every process; every
    # process holds and checks the whole result
    items = dryrun_items(2 * n_ranks)
    paths_sh = profile.profile_paths_sharded(items,
                                             sharded.relabel(mesh, "gap"))
    paths_single = profile.profile_paths(items, home)
    dp_ok = len(paths_sh) == len(items) and all(
        np.array_equal(a, b) for a, b in zip(paths_sh, paths_single))

    flags: list = [None] * world.size
    dist.all_gather_object(flags, (ladder_ok, blocks_ok, dp_ok))
    result = {
        "ladder_parity_cross_process": all(f[0] for f in flags),
        "parity_vs_single_process": all(f[1] for f in flags),
        "dp_parity_cross_process": all(f[2] for f in flags),
        "processes": world.size,
        "backend": world.backend,
        "global_ranks": mesh.size,
        "local_ranks": len(mesh.local),
        "device": str(home),
        "final_blocks": None if got is None else len(got),
        "rank_exchange_bytes": moved.get("rank_exchange_bytes", 0),
        "rank_process_bytes": moved.get("rank_process_bytes", 0),
        "blocks": None if fin is None else {
            "num_collected": int(fin.num_collected),
            "num_after_suffix": int(fin.num_after_suffix),
            "start": fin.final_start.tolist(),
            "depth": fin.final_depth.tolist(),
            "positions": fin.final_positions.tolist()},
    }
    if int(pid) == 0:
        print(RESULT_TAG + json.dumps(result), flush=True)
    shutdown()
    return 0


def run_multiprocess_dryrun(n_processes: int = 2, ranks_per_process: int = 4,
                            device: str = "cuda", timeout: float = 300,
                            visible: Optional[Sequence[str]] = None) -> dict:
    """Spawn ``n_processes`` processes of ``ranks_per_process`` ranks
    each on ``device``'s type, run the sharded rotation stage and the
    rank-split gap DP over the global mesh, and return process 0's
    result, with ``ok`` true when its three parities hold and every
    process exited 0, and every process's ``exit_codes``.  ``visible``
    gives each process its ``CUDA_VISIBLE_DEVICES`` (default: every
    process sees every card, so processes that share a card take
    gloo).  A process that runs
    over ``timeout`` seconds is killed and the result is not ok.
    ``device="cuda"`` without a CUDA device raises: the CPU runs only
    when asked for."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("run_multiprocess_dryrun: no CUDA device is "
                           "available (pass device='cpu' to run on the "
                           "CPU)")
    port = free_port()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    envs = []
    for pid in range(n_processes):
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in [env.get("PYTHONPATH")] if p])
        for k in ("CSA_TPU_COORDINATOR", "CSA_TPU_NUM_PROCESSES",
                  "CSA_TPU_PROCESS_ID"):
            env.pop(k, None)
        if visible is not None:
            env["CUDA_VISIBLE_DEVICES"] = visible[pid]
        envs.append(env)
    argvs = [[sys.executable, "-m", "csa_tpu_torch.parallel.distributed",
              _CHILD_FLAG, str(port), str(n_processes), str(pid),
              str(ranks_per_process), device, str(timeout)]
             for pid in range(n_processes)]
    try:
        outs = run_processes(argvs, timeout=timeout, envs=envs)
    except TimeoutError as e:
        return {"ok": False, "error": str(e)}
    rcs = [rc for rc, _, _ in outs]
    bad = [(pid, rc, err) for pid, (rc, _, err) in enumerate(outs) if rc]
    if bad:
        pid, rc, err = bad[0]
        return {"ok": False, "exit_codes": rcs,
                "error": f"process {pid} exited {rc}: {err[-2000:]}"}
    for line in outs[0][1].splitlines():
        if line.startswith(RESULT_TAG):
            res = json.loads(line[len(RESULT_TAG):])
            res["ok"] = bool(res["ladder_parity_cross_process"]
                             and res["parity_vs_single_process"]
                             and res["dp_parity_cross_process"])
            res["exit_codes"] = rcs
            return res
    return {"ok": False, "exit_codes": rcs,
            "error": "no result line from process 0"}


if __name__ == "__main__":
    # run as the package's module, whose world the mesh code reads (not
    # as a second copy of it named __main__)
    from csa_tpu_torch.parallel import distributed as _self

    if len(sys.argv) > 1 and sys.argv[1] == _CHILD_FLAG:
        sys.exit(_self._child_main(sys.argv[2:]))
    import argparse

    parser = argparse.ArgumentParser(
        description="the multi-process dryrun: 2 processes x 4 ranks")
    parser.add_argument("--device", default="cuda",
                        help="torch device type of the ranks (default cuda)")
    print(json.dumps(_self.run_multiprocess_dryrun(
        device=parser.parse_args().device)))
