"""The port's multi-process launch (csa_tpu_torch.parallel.distributed) on
the CPU over gloo: the flag and environment handling of ``initialize``
(the counterparts of tests/test_distributed.py's first two tests), the
split of a mesh over processes, every exchange of ``Ranks`` across two
real processes against the single-process ``Ranks``, the three-legged
dryrun (its ladder leg also against the JAX package's
``rotation_final_jax`` on its virtual mesh), its kill on a timeout, and
the CLI run as 2 and 3 processes (each in its own directory) against
the single-process port, the fixtures and the JAX package's CLI,
with one run of giants forced to the column-sharded path.

Every spawned group of processes has a deadline and is killed when it
runs over; each picks a free port."""

import json
import os
import pathlib
import sys

import numpy as np
import pytest
import torch

from csa_tpu import cli as jcli
from csa_tpu import config as jconfig
from csa_tpu.index import engine as jengine
from csa_tpu.parallel import sharded as jsharded
from csa_tpu_torch import cli
from csa_tpu_torch.parallel import distributed, sharded
from csa_tpu_torch.utils import PROFILER

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
TIMEOUT = 240     # seconds a spawned group of processes may take
CPU = torch.device("cpu")


def _env() -> dict:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    for k in ("CSA_TPU_COORDINATOR", "CSA_TPU_NUM_PROCESSES",
              "CSA_TPU_PROCESS_ID"):
        env.pop(k, None)
    return env


# -- initialize and the mesh ------------------------------------------------

def test_initialize_noop_without_coordinator(monkeypatch):
    """No coordinator flag or environment: a single process, nothing
    touched."""
    monkeypatch.delenv("CSA_TPU_COORDINATOR", raising=False)
    assert distributed.initialize() is False
    assert distributed.current() is None
    assert not torch.distributed.is_initialized()


def test_env_values_parsed(monkeypatch):
    """The CSA_TPU_* values reach init_process_group, over tcp:// with a
    finite timeout; CPU ranks take gloo."""
    seen = {}

    def fake_init(backend, init_method=None, world_size=None, rank=None,
                  timeout=None):
        seen.update(backend=backend, init_method=init_method,
                    world_size=world_size, rank=rank, timeout=timeout)

    dist = torch.distributed
    monkeypatch.setenv("CSA_TPU_COORDINATOR", "h0:1234")
    monkeypatch.setenv("CSA_TPU_NUM_PROCESSES", "3")
    monkeypatch.setenv("CSA_TPU_PROCESS_ID", "1")
    monkeypatch.setattr(dist, "init_process_group", fake_init)
    monkeypatch.setattr(dist, "get_world_size", lambda: 3)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    monkeypatch.setattr(distributed, "_WORLD", None)
    assert distributed.initialize(timeout=30) is True
    assert seen.pop("timeout").total_seconds() == 30
    assert seen == {"backend": "gloo", "init_method": "tcp://h0:1234",
                    "world_size": 3, "rank": 1}
    world = distributed.current()
    assert (world.rank, world.size, world.backend) == (1, 3, "gloo")


def test_initialize_needs_the_process_count_and_id(monkeypatch):
    monkeypatch.delenv("CSA_TPU_NUM_PROCESSES", raising=False)
    monkeypatch.delenv("CSA_TPU_PROCESS_ID", raising=False)
    with pytest.raises(ValueError, match="--num-processes"):
        distributed.initialize("h0:1234")


def test_initialize_raises_when_the_world_does_not_form():
    """A process whose peers never come raises when its timeout passes;
    nothing falls back to one process."""
    port = distributed.free_port()
    with pytest.raises(Exception):
        distributed.initialize(f"127.0.0.1:{port}", 2, 1, timeout=2)
    assert distributed.current() is None


@pytest.mark.parametrize("rank", [0, 1])
def test_make_mesh_gives_each_process_a_contiguous_block(monkeypatch, rank):
    """Process p owns ranks [p L, (p + 1) L), laid round-robin over its
    own devices; the rank count must split evenly over the processes."""
    monkeypatch.setattr(distributed, "_WORLD",
                        distributed.World(rank, 2, "gloo", None))
    mesh = sharded.make_mesh(shape=(4, 1), devices=[CPU])
    mine = (CPU, CPU)
    assert mesh.devices == ((*mine, None, None) if rank == 0
                            else (None, None, *mine))
    assert mesh.local == ((0, 1) if rank == 0 else (2, 3))
    assert mesh.home == CPU
    assert [mesh.owner(r) for r in range(4)] == [0, 0, 1, 1]
    assert sharded.make_mesh(devices=[CPU]).size == 2   # a rank a process
    with pytest.raises(ValueError, match="split evenly over 2 processes"):
        sharded.make_mesh(shape=(3, 1), devices=[CPU])
    local = sharded.local_mesh(mesh, "col")
    assert local.devices == mine and local.world is None
    assert local.shape == (2,) and local.axis == ("col",)
    assert sharded.relabel(mesh, "gap").world is mesh.world


# -- Ranks across two processes ---------------------------------------------

# one program of every exchange, run by the single-process reference and
# by each of the two processes
EXCHANGES = r'''
import torch
from csa_tpu_torch.parallel import dsort


def exchanges(ranks):
    D = ranks.size
    xs = ranks.each(lambda r, _: torch.randint(
        -50, 50, (6,), generator=torch.Generator().manual_seed(100 + r)),
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
'''

CHILD_RANKS = EXCHANGES + r'''
import json, sys
from csa_tpu_torch.parallel import distributed, sharded
from csa_tpu_torch.utils import PROFILER

torch.set_num_threads(1)
port, pid = sys.argv[1], int(sys.argv[2])
distributed.initialize(f"127.0.0.1:{port}", 2, pid, timeout=120)
PROFILER.enabled = True
mesh = sharded.make_mesh(4, (4, 1), devices=["cpu"])
res = exchanges(sharded.Ranks(mesh))
res["counters"] = dict(PROFILER.counters)
print("RANKS " + json.dumps(res), flush=True)
distributed.shutdown()
'''


def test_ranks_exchanges_across_two_processes():
    """ppermute (within and across processes), all_gather, psum, pmax,
    item, gather to first, scatter, replicate and the merge-split sort
    over 4 ranks of 2 processes equal the single-process Ranks on the
    same seeded tensors, rank for rank; every process holds the whole
    gather and the same items; the exchange bytes keep their meaning
    and what crossed between the processes is counted apart."""
    port = distributed.free_port()
    outs = distributed.run_processes(
        [[sys.executable, "-c", CHILD_RANKS, str(port), str(pid)]
         for pid in range(2)], timeout=TIMEOUT, envs=[_env(), _env()])
    for rc, _, err in outs:
        assert rc == 0, err[-3000:]
    got = [json.loads(next(l for l in out.splitlines()
                           if l.startswith("RANKS "))[6:])
           for _, out, _ in outs]
    ns = {}
    exec(EXCHANGES, ns)
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        want = ns["exchanges"](sharded.Ranks(
            sharded.make_mesh(4, (4, 1), devices=[CPU])))
        single_bytes = PROFILER.counters["rank_exchange_bytes"]
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    for pid, res in enumerate(got):
        mine = (2 * pid, 2 * pid + 1)
        for key, vals in want.items():
            if key in ("gather_to_first", "item"):
                assert res[key] == vals, (pid, key)
                continue
            for r in range(4):
                assert res[key][r] == (vals[r] if r in mine else None), \
                    (pid, key, r)
        assert res["counters"]["rank_exchange_bytes"] == single_bytes
        assert res["counters"]["rank_process_bytes"] > 0
        assert "rank_peer_copy_bytes" not in res["counters"]


# -- the dryrun -------------------------------------------------------------

def test_multiprocess_dryrun_parity():
    """2 processes x 2 ranks: the ladder over both processes equals the
    single-process stage, its blocks equal the numpy cyclic engine's and
    the JAX package's rotation_final_jax on its 8-device virtual mesh,
    and the rank-split gap DP equals the single launch in every
    process."""
    res = distributed.run_multiprocess_dryrun(2, 2, "cpu", timeout=TIMEOUT)
    assert res.get("ok"), res
    assert res["ladder_parity_cross_process"] is True
    assert res["parity_vs_single_process"] is True
    assert res["dp_parity_cross_process"] is True
    assert (res["processes"], res["global_ranks"], res["local_ranks"],
            res["backend"]) == (2, 4, 2, "gloo")
    assert res["rank_process_bytes"] > 0
    jmesh = jsharded.make_mesh()
    assert jmesh.devices.size == 8
    want = jengine.rotation_final_jax(distributed.dryrun_set(), mesh=jmesh)
    blocks = res["blocks"]
    assert blocks["num_collected"] == want.num_collected
    assert blocks["num_after_suffix"] == want.num_after_suffix
    np.testing.assert_array_equal(blocks["start"], want.final_start)
    np.testing.assert_array_equal(blocks["depth"], want.final_depth)
    np.testing.assert_array_equal(blocks["positions"], want.final_positions)
    assert res["final_blocks"] == len(want.final_start) > 0


def test_dryrun_past_its_timeout_is_killed():
    """A group that runs over its deadline is killed and the result is
    not ok, within the call."""
    res = distributed.run_multiprocess_dryrun(2, 2, "cpu", timeout=0.5)
    assert res["ok"] is False
    assert "ran over" in res["error"]


# -- the CLI as several processes -------------------------------------------

# a process of a CLI run: the port's CLI with a count of the giants sent
# to the column-sharded path; "giant" lowers the cap so that every merge
# after a round's first goes there (bands of 64 rows keep the plain
# version's row loop short)
CHILD_CLI = r'''
import sys
from csa_tpu_torch import cli
from csa_tpu_torch.align import progressive
from csa_tpu_torch.dp import seqpar

if sys.argv[1] == "giant":
    progressive.BATCH_DIRS_CAP = 1
    seqpar.BAND_ROWS = 64
calls = []
real = seqpar.dp_path_seqpar


def spy(*args, **kw):
    calls.append(1)
    return real(*args, **kw)


seqpar.dp_path_seqpar = spy
rc = cli.main(sys.argv[2:])
print("SEQPAR_CALLS", len(calls))
sys.exit(rc)
'''


def _family(seed=1, k=6, n=360):
    """k rotated, mutated copies of one random sequence."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n)
    rows = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=n // 40)
        row[idx] = rng.integers(0, 4, size=len(idx))
        rows.append(row)
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    return "".join(f">s{i}\n{letters[r].tobytes().decode()}\n"
                   for i, r in enumerate(rows))


INPUTS = {"t1": lambda: (FIX / "tiny" / "t1.txt").read_text(),
          "family": _family}
# (name, mode, processes, mesh, giants forced)
WORLDS = [("t1", "R", 2, "4x1", False), ("t1", "N", 2, "4x1", False),
          ("family", "R", 2, "4x1", False), ("family", "N", 2, "4x1", False),
          ("t1", "N", 3, "3x1", False), ("t1", "N", 2, "4x1", True)]


def _wid(w):
    return f"{w[0]}-{w[1]}-{w[2]}p-{w[3]}" + ("-giants" if w[4] else "")


def _outputs(d: pathlib.Path, name: str, mode: str) -> dict:
    out = {"Rotated": (d / f"{name}-Rotated.fasta").read_bytes()}
    if mode == "N":
        out["Aligned"] = (d / f"{name}-Aligned.fasta").read_bytes()
    return out


@pytest.fixture(scope="module")
def cli_worlds(tmp_path_factory):
    """Every world of WORLDS at once (one port each), each process in a
    directory of its own; then the references: the single-process port
    and the JAX package's CLI (its native host engine) on the seeded
    set, the fixtures for t1."""
    root = tmp_path_factory.mktemp("worlds")
    argvs, cwds, where = [], [], []
    for w in WORLDS:
        name, mode, n, mesh, giant = w
        port = distributed.free_port()
        for pid in range(n):
            d = root / _wid(w) / f"p{pid}"
            d.mkdir(parents=True)
            (d / f"{name}.txt").write_text(INPUTS[name]())
            argvs.append([sys.executable, "-c", CHILD_CLI,
                          "giant" if giant else "plain",
                          *([] if mode == "N" else [mode]), f"{name}.txt",
                          "--device", "cpu", "--backend", "sharded",
                          "--mesh", mesh, "--coordinator",
                          f"127.0.0.1:{port}", "--num-processes", str(n),
                          "--process-id", str(pid)])
            cwds.append(d)
            where.append((w, pid))
    outs = distributed.run_processes(argvs, timeout=TIMEOUT, cwds=cwds,
                                     envs=[_env() for _ in argvs])
    runs = {}
    for (w, pid), d, res in zip(where, cwds, outs):
        runs.setdefault(w, []).append((d, *res))

    refs = {}
    for name in INPUTS:
        for tag in ("port", "jax"):
            d = root / f"ref-{name}-{tag}"
            d.mkdir()
            (d / f"{name}.txt").write_text(INPUTS[name]())
            cwd = os.getcwd()
            os.chdir(d)
            try:
                if tag == "port":
                    assert cli.main([f"{name}.txt", "--device", "cpu"]) == 0
                else:
                    assert jcli.main([f"{name}.txt", "--backend",
                                      "native"]) == 0
            finally:
                os.chdir(cwd)
                jconfig.set_run_config(jconfig.RunConfig())
            refs[name, tag] = _outputs(d, name, "N")
    refs["t1", "fixture"] = {
        "Rotated": (FIX / "tiny" / "t1-Rotated.fasta").read_bytes(),
        "Aligned": (FIX / "tiny" / "t1-Aligned.fasta").read_bytes()}
    return runs, refs


@pytest.mark.parametrize("world", WORLDS, ids=_wid)
def test_cli_across_processes_writes_the_single_process_output(cli_worlds,
                                                                world):
    """Every process of the world writes, next to its own input, the
    rotated (and, in mode N, aligned) FASTA of the single-process port,
    byte for byte, which is also the fixture's or the JAX package's;
    --mesh 3x1 over 3 processes takes the single-device stage on each
    process's rank; forced giants go to the column-sharded path in
    every process."""
    runs, refs = cli_worlds
    name, mode, n, mesh, giant = world
    assert len(runs[world]) == n
    for pid, (d, rc, out, err) in enumerate(runs[world]):
        assert rc == 0, err[-3000:]
        ranks = int(mesh.split("x")[0]) * int(mesh.split("x")[1])
        assert (f"> Multi-host runtime: process {pid}/{n}, {ranks} global "
                f"ranks, backend gloo") in out
        got = _outputs(d, name, mode)
        for ref in ("port", "jax", "fixture"):
            if (name, ref) in refs:
                want = refs[name, ref]
                assert got == {k: want[k] for k in got}, (pid, ref)
        calls = int(out.split("SEQPAR_CALLS")[1].split()[0])
        assert (calls > 0) == giant, calls
