"""The port's routing against ``csa_tpu``'s: the routes of ``--backend``
(``numpy``, ``native``, ``device``; ``auto``), the gap-DP gates of the
installed RunConfig (``--device-min-cells``), and the native library's
rotation and linear-index entries.

Each route of the port is held to the same route of the JAX package
(``device`` to ``jax``) on seeded ACGT sets and a small fixture:
rotations, cascade counts and aligned rows.  Sets with code-4 rows
(IUPAC letters) are held to ``csa_tpu --backend jax``, the contract
(README): the JAX package's native fill reads past its table on them and
its numpy fill raises.  Everything runs on the CPU; the host routes are
also run through the CLI with ``--device cuda`` (its default), where
they must make no CUDA call."""

import dataclasses
import functools
import io
import pathlib

import numpy as np
import pytest
import torch

from csa_tpu import config as jconfig
from csa_tpu import native as jnative
from csa_tpu.align import anchors as janchors
from csa_tpu.align import progressive as jprogressive
from csa_tpu.align import runner as jrunner
from csa_tpu.io import fasta as jfio
from csa_tpu.rotation import pipeline as jrot
from csa_tpu.utils.profiling import PROFILER as JPROFILER
from csa_tpu_torch import cli, config, native
from csa_tpu_torch.align import anchors, progressive, runner
from csa_tpu_torch.io import fasta as tfio
from csa_tpu_torch.rotation import pipeline as rot
from csa_tpu_torch.utils import PROFILER

import torch_jax_native
from test_torch_iupac import _random_set

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

REPO = pathlib.Path(__file__).resolve().parent.parent
TINY = REPO / "tests" / "fixtures" / "tiny"
BIG = str(1 << 62)
# the port's route and the JAX package's route it is held to
ROUTES = [("numpy", "numpy"), ("native", "native"), ("device", "jax")]


@pytest.fixture(autouse=True)
def default_configs():
    """Each test starts and ends with both packages' default RunConfig
    (the CLI installs the one its flags give, for the process)."""
    config.set_run_config(config.RunConfig())
    jconfig.set_run_config(jconfig.RunConfig())
    yield
    config.set_run_config(config.RunConfig())
    jconfig.set_run_config(jconfig.RunConfig())


def _source(tmp_path, name):
    """``name``: a tiny fixture, or ``seed<N>`` for a seeded ACGT set
    (``iupac<N>`` with IUPAC letters) of tests/test_torch_iupac.py."""
    src = tmp_path / f"{name}.txt"
    if name.startswith("seed"):
        src.write_text(_random_set(int(name[4:]), False))
    elif name.startswith("iupac"):
        src.write_text(_random_set(int(name[5:]), True))
    else:
        src.write_bytes((TINY / f"{name}.txt").read_bytes())
    return src


def _run(src, tmp_path, pkg, route):
    """Rotate and align ``src`` on ``route`` of the JAX package
    (``pkg`` "jax") or the port (the device route on the CPU); returns
    the rotations, the cascade counts and the aligned file's bytes."""
    fio = jfio if pkg == "jax" else tfio
    seqs = fio.load_fasta(str(src), log=io.StringIO())
    if pkg == "jax":
        res = jrot.analyze(seqs, backend=route, log=io.StringIO())
    else:
        res = rot.analyze(seqs, device="cpu", backend=route,
                          log=io.StringIO())
    codes = [np.roll(e, -int(r))
             for e, r in zip(seqs.encoded_all(), res.rotations)]
    if pkg == "jax":
        result = jrunner.run_alignment(codes, dp_backend=route,
                                       log=io.StringIO())
        save = jrunner.save_alignment
    else:
        result = runner.run_alignment(codes, device="cpu", dp_backend=route,
                                      log=io.StringIO())
        save = runner.save_alignment
    out = tmp_path / f"{src.stem}-{pkg}-{route}.fasta"
    save(str(out), result, codes, seqs.names, res.rotations,
         log=io.StringIO())
    counts = (res.num_collected, res.num_after_suffix, res.num_after_unique,
              res.num_chains)
    return [int(r) for r in res.rotations], counts, out.read_bytes()


@pytest.mark.parametrize("name", ["seed1", "seed2", "a-diverge-1"])
@pytest.mark.parametrize("route,jax_route", ROUTES)
def test_route_matches_jax_route(tmp_path, name, route, jax_route):
    src = _source(tmp_path, name)
    assert _run(src, tmp_path, "torch", route) == \
        _run(src, tmp_path, "jax", jax_route)


def _gates(merge, batch):
    """Install both packages' RunConfig with these gap-DP gates."""
    config.set_run_config(config.RunConfig(device_min_cells=int(merge),
                                           batch_min_cells=int(batch)))
    jconfig.set_run_config(jconfig.RunConfig(device_min_cells=int(merge),
                                             batch_min_cells=int(batch)))


@pytest.fixture
def jax_device_route():
    """Every merge of either package's device route on its device fill
    (the JAX package's is the contract of the tests that use it)."""
    _gates(0, 0)


@pytest.mark.parametrize("name", ["iupac3", "iupac4", "seed1", "seed2"])
@pytest.mark.parametrize("route", ["numpy", "native"])
def test_iupac_sets_host_routes_match_jax_device_route(
        jax_device_route, tmp_path, name, route):
    """The seeded sets of tests/test_torch_iupac.py (3 and 4 with code-4
    rows) on the port's host routes, held to ``csa_tpu --backend jax``."""
    src = _source(tmp_path, name)
    assert _run(src, tmp_path, "torch", route) == \
        _run(src, tmp_path, "jax", "jax")


def _dispatches(pkg, codes):
    """(aligned code rows, dp_device_dispatches) of one alignment of
    ``codes`` on the device route of ``pkg`` with its profiler on."""
    prof = JPROFILER if pkg == "jax" else PROFILER
    prof.reset()
    prof.enabled = True
    try:
        if pkg == "jax":
            result = jrunner.run_alignment(codes, dp_backend="jax",
                                           log=io.StringIO())
            rows = jrunner.render_alignment(result, codes)
        else:
            result = runner.run_alignment(codes, device="cpu",
                                          log=io.StringIO())
            rows = runner.render_alignment(result, codes)
        return ([r.tolist() for r in rows],
                prof.counters.get("dp_device_dispatches", 0))
    finally:
        prof.enabled = False
        prof.reset()


def _rotated_codes(src):
    seqs = tfio.load_fasta(str(src), log=io.StringIO())
    res = rot.analyze(seqs, backend="native", log=io.StringIO())
    return [np.roll(e, -int(r))
            for e, r in zip(seqs.encoded_all(), res.rotations)]


@pytest.mark.parametrize("name", ["seed1", "seed2", "a-diverge-1"])
@pytest.mark.parametrize("merge,batch", [("0", "0"), (BIG, BIG),
                                         (BIG, "0"), ("0", BIG)],
                         ids=["all_card", "all_host", "merge_gate_only",
                              "round_gate_only"])
def test_gates_route_as_jax_counts(tmp_path, name, merge, batch):
    """Both gates at 0 (every merge on the card), above every merge
    (every merge on the host) and one of each: the aligned rows equal
    the host route's, and the device dispatches equal ``csa_tpu``'s
    under the same gates."""
    codes = _rotated_codes(_source(tmp_path, name))
    want = runner.render_alignment(
        runner.run_alignment(codes, dp_backend="native", log=io.StringIO()),
        codes)
    _gates(merge, batch)
    rows, n = _dispatches("torch", codes)
    jrows, jn = _dispatches("jax", codes)
    assert rows == [r.tolist() for r in want] == jrows
    assert n == jn
    if merge == batch == BIG:
        assert n == 0
    if merge == batch == "0":
        assert n > 0


def _one_gap(seed=11, k=5):
    """One gap's substrings: every round of it holds one merge, so the
    per-merge gate decides each."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 4, size=int(rng.integers(20, 60))).astype(
        np.int8) for _ in range(k)]


@pytest.mark.parametrize("source", ["flag", "run_config"])
def test_merge_gate_reaches_routing(monkeypatch, tmp_path, source):
    """``--device-min-cells`` (through the CLI's RunConfig) and a
    RunConfig installed with ``set_run_config`` decide every single
    merge: 0 sends each to the card, a gate above every merge none, as
    ``csa_tpu`` counts."""
    src = _source(tmp_path, "a-diverge-1")
    monkeypatch.chdir(tmp_path)
    gap = _one_gap()
    counts = {}
    for gate in ("0", BIG):
        if source == "flag":
            assert cli.main(["A", src.name, "--device", "cpu",
                             "--device-min-cells", gate]) == 0
            # the round gate has no flag: at 0 every round of one merge
            # meets the merge gate
            config.set_run_config(dataclasses.replace(
                config.run_config(), batch_min_cells=0))
            jconfig.set_run_config(jconfig.RunConfig(
                device_min_cells=int(gate), batch_min_cells=0))
        else:
            _gates(gate, 0)
        assert config.run_config().device_min_cells == int(gate)
        for pkg in ("torch", "jax"):
            prof = JPROFILER if pkg == "jax" else PROFILER
            prof.reset()
            prof.enabled = True
            try:
                if pkg == "jax":
                    jprogressive.progressive_dp_batched([gap])
                else:
                    progressive.progressive_dp_batched([gap], device="cpu")
                counts[pkg, gate] = prof.counters.get(
                    "dp_device_dispatches", 0)
            finally:
                prof.enabled = False
                prof.reset()
    assert counts["torch", "0"] == counts["jax", "0"] == len(gap) - 1
    assert counts["torch", BIG] == counts["jax", BIG] == 0


def test_the_flag_sets_the_gate(monkeypatch, tmp_path):
    """``--device-min-cells`` is the merge gate the run reads; the round
    gate keeps its default."""
    src = _source(tmp_path, "a-diverge-1")
    monkeypatch.chdir(tmp_path)
    assert cli.main(["A", src.name, "--device", "cpu",
                     "--device-min-cells", "123"]) == 0
    assert config.run_config().device_min_cells == 123
    assert config.run_config().batch_min_cells == \
        config.RunConfig().batch_min_cells


@pytest.mark.parametrize("batch", ["0", BIG])
def test_round_gate_reaches_routing(batch):
    """The round gate decides whether a round's batch is one launch (0)
    or runs on the host (above it), as ``csa_tpu`` counts."""
    gaps = [_one_gap(seed) for seed in range(4)]
    _gates(0, batch)
    counts = []
    outs = []
    for pkg in ("torch", "jax"):
        prof = JPROFILER if pkg == "jax" else PROFILER
        prof.reset()
        prof.enabled = True
        try:
            if pkg == "jax":
                out = jprogressive.progressive_dp_batched(gaps)
            else:
                out = progressive.progressive_dp_batched(gaps, device="cpu")
            counts.append(prof.counters.get("dp_device_dispatches", 0))
            outs.append([[s.tolist() for s in g] for g in out])
        finally:
            prof.enabled = False
            prof.reset()
    assert counts[0] == counts[1] == (4 if batch == "0" else 0)
    assert outs[0] == outs[1]


@pytest.mark.parametrize("threshold,total,want", [
    (None, -1, "native"), (None, 0, "device"), (1000, 999, "native"),
    (1000, 1000, "device"), (1000, 10**9, "device")])
def test_resolve_auto_backend(monkeypatch, threshold, total, want):
    """``auto`` rotates on the native route below the threshold and on
    the device at or above it, and aligns on the native route; the
    default threshold is AUTO_DEVICE_MIN_CHARS (``total`` counts from
    it)."""
    if threshold is None:
        total += cli.AUTO_DEVICE_MIN_CHARS
    else:
        monkeypatch.setattr(cli, "AUTO_DEVICE_MIN_CHARS", threshold)
    assert cli.resolve_routes("auto", total) == (want, "native", False)


@pytest.mark.parametrize("backend,want", [
    ("device", ("device", "device", False)),
    ("sharded", ("device", "device", True)),
    ("native", ("native", "native", False)),
    ("numpy", ("numpy", "numpy", False))])
def test_resolve_routes(backend, want):
    """Every other ``--backend`` whatever the size: ``sharded`` is the
    device route over the mesh."""
    for total in (0, cli.AUTO_DEVICE_MIN_CHARS, 10**12):
        assert cli.resolve_routes(backend, total) == want


@pytest.fixture
def no_cuda(monkeypatch):
    """Any CUDA call fails the test."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA call on a host route")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "_lazy_init", refuse)
    yield
    assert not torch.cuda.is_initialized()


@pytest.mark.parametrize("mode", ["N", "R", "A"])
@pytest.mark.parametrize("how", ["native", "numpy", "auto_native",
                                 "numpy_gate_0"])
def test_host_routes_make_no_cuda_call(no_cuda, monkeypatch, tmp_path, mode,
                                       how):
    """The CLI at its default ``--device cuda`` on a host route: no CUDA
    call, and the fixture's output; a merge gate of 0 does not send a
    host route's merges to the card."""
    name = "a-diverge-1"
    src = _source(tmp_path, name)
    monkeypatch.chdir(tmp_path)
    argv = [] if mode == "N" else [mode]
    argv += [src.name]
    if how == "numpy_gate_0":
        argv += ["--backend", "numpy", "--device-min-cells", "0"]
    elif how == "auto_native":
        monkeypatch.setattr(cli, "AUTO_DEVICE_MIN_CHARS", int(BIG))
        argv += ["--backend", "auto"]
    else:
        argv += ["--backend", how]
    assert cli.main(argv) == 0
    if mode in ("N", "R"):
        assert (tmp_path / f"{name}-Rotated.fasta").read_bytes() == \
            (TINY / f"{name}-Rotated.fasta").read_bytes()
    if mode == "N":
        assert (tmp_path / f"{name}-Aligned.fasta").read_bytes() == \
            (TINY / f"{name}-Aligned.fasta").read_bytes()


@pytest.mark.parametrize("argv", [
    ["R", "a-diverge-1.txt", "--backend", "auto"],
    ["a-diverge-1.txt", "--backend", "auto"],
    ["a-diverge-1.txt", "--backend", "device"]])
def test_device_route_without_a_card_exits(monkeypatch, tmp_path, argv):
    """``auto`` resolving to the device, like ``--backend device``, exits
    non-zero without a CUDA device; nothing runs on the CPU unasked."""
    _source(tmp_path, "a-diverge-1")
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cli, "AUTO_DEVICE_MIN_CHARS", 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        cli.main(argv)
    assert e.value.code not in (0, None)
    assert not (tmp_path / "a-diverge-1-Rotated.fasta").exists()


@pytest.mark.parametrize("backend,ok", [("device", True),
                                        ("native", True), ("jax", False),
                                        ("tpu", False)])
def test_backend_flag_sets_the_route(tmp_path, monkeypatch, backend, ok):
    """``--backend`` takes the port's routes (``device`` where
    ``csa_tpu`` says ``jax``); a value that is no route is refused."""
    src = _source(tmp_path, "a-diverge-1")
    monkeypatch.chdir(tmp_path)
    argv = ["R", src.name, "--device", "cpu", "--backend", backend]
    if ok:
        assert cli.main(argv) == 0
        assert (tmp_path / "a-diverge-1-Rotated.fasta").read_bytes() == \
            (TINY / "a-diverge-1-Rotated.fasta").read_bytes()
    else:
        with pytest.raises(SystemExit) as e:
            cli.main(argv)
        assert e.value.code == 2


def _cli_run(tmp_path, tag, argv):
    """One profiled CLI job on a-diverge-1 in a directory of its own;
    returns its output files' bytes, its ``dp_device_dispatches`` and
    the names of its phases."""
    work = tmp_path / tag
    work.mkdir()
    src = _source(work, "a-diverge-1")
    PROFILER.reset()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(work)
            assert cli.main([src.name, "--device", "cpu", "--profile",
                             *argv]) == 0
        counters = dict(PROFILER.counters)
        phases = set(PROFILER.phases)
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    files = {p.name: p.read_bytes() for p in sorted(work.iterdir())
             if p.name != src.name}
    return files, counters.get("dp_device_dispatches", 0), phases


def _dp_run():
    """The aligned rows and ``dp_device_dispatches`` of one gap alone
    (the merge gate decides each of its rounds) and of four gaps
    together (the round gate decides)."""
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        outs = [progressive.progressive_dp_batched(gaps, device="cpu")
                for gaps in ([_one_gap()],
                             [_one_gap(seed) for seed in range(4)])]
        n = PROFILER.counters.get("dp_device_dispatches", 0)
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    rows = [[[r.tolist() for r in g] for g in out] for out in outs]
    return rows, n, set()


@pytest.mark.parametrize("name,value,how", [
    ("CSA_TPU_BACKEND", "numpy", "cli"),
    ("CSA_TPU_AUTO_DEVICE_MIN", "0", "cli_auto"),
    ("CSA_TPU_DEVICE_MIN_CELLS", BIG, "dp"),
    ("CSA_TPU_BATCH_MIN_CELLS", BIG, "dp")])
def test_removed_variables_change_nothing(monkeypatch, tmp_path, name,
                                          value, how):
    """The four variables that once overrode the route and the gates
    are read no more: each, at a value that would have changed the
    route or a gate, leaves the output, ``dp_device_dispatches`` and
    the phases (``rot.block_stage[<route>]`` among them) as they are.
    Both gates are at 0, so that the device route dispatches."""
    monkeypatch.setattr(config, "RunConfig", functools.partial(
        config.RunConfig, batch_min_cells=0))
    _gates(0, 0)
    argv = ["--device-min-cells", "0"]
    if how == "cli_auto":
        argv += ["--backend", "auto"]

    def run(tag):
        return _dp_run() if how == "dp" else _cli_run(tmp_path, tag, argv)

    want = run("without")
    monkeypatch.setenv(name, value)
    assert run("with") == want
    assert (want[1] > 0) == (how != "cli_auto")
    if how != "dp":
        stage = {p for p in want[2] if p.startswith("rot.block_stage[")}
        assert stage == {"rot.block_stage[native]" if how == "cli_auto"
                         else "rot.block_stage[torch]"}


def _encoded(tmp_path, name):
    return tfio.load_fasta(str(_source(tmp_path, name)),
                           log=io.StringIO()).encoded_all()


@pytest.mark.parametrize("name", ["seed1", "iupac3", "a-repeat-0",
                                  "a-diverge-1"])
def test_native_rotation_analyze_matches_jax(tmp_path, name):
    enc = _encoded(tmp_path, name)
    got = native.rotation_analyze(enc, max_blocks=4)  # the retry path
    want = jnative.rotation_analyze(enc)
    assert got.num_collected == want.num_collected
    for f in ("start", "end", "depth", "keep_suffix", "unique",
              "positions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("name", ["seed1", "iupac3", "a-repeat-0",
                                  "a-diverge-1"])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_linear_index_matches_jax(tmp_path, name, route):
    """``native.linear_index`` against ``csa_tpu``'s, and the port's
    linear index on each host route against ``csa_tpu``'s numpy one."""
    enc = _encoded(tmp_path, name)
    k = len(enc)
    s = np.concatenate([np.append(np.asarray(e, np.int64) + k, i)
                        for i, e in enumerate(enc)])
    for a, b in zip(native.linear_index(s, k + 5),
                    jnative.linear_index(s, k + 5)):
        np.testing.assert_array_equal(a, b)
    got = anchors.build_linear_index(enc, backend=route)
    want = janchors.build_linear_index(enc, backend="numpy")
    for f in ("seq_of", "pos_of", "cap", "lcp"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
