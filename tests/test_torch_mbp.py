"""The port at ``csa_tpu``'s Mbp configurations, cut to a CPU's size.

``csa_tpu`` runs two large configurations (bench.py): the full pipeline
on 8 x 1 Mbp (``_mbp_set()``, seed 7) and mode R on 4 x 5 Mbp
(``_mbp_set(n=5_000_000, k=4, seed=13)``).  The card runs them at full
size (``chip_smoke.py`` phases ``mbp_full`` and ``mbp5``, against
``csa_tpu``'s digests; ``tests/torch_mbp_walls.py``).  Here:

* ``chip_smoke._mbp_set`` (the card's copy of the generator, which
  imports nothing of the JAX package) is ``bench._mbp_set``;
* the full pipeline on 8 x 20 kbp of the same generator (seed 7),
  through the port's CLI on ``--backend device --device cpu`` and
  ``native``, writes ``csa_tpu.cli``'s bytes on ``--backend jax`` and
  ``native``: ``-Rotated.fasta`` and ``-Aligned.fasta``;
* the same with every merge of the gap DP on the device route's fill
  (both gates at 0), its rounds batched whole or cut small by
  ``BATCH_DIRS_BYTES``: the output does not depend on the partition;
* mode R on 4 x 50 kbp (seed 13) likewise.

Both sets find chains (a set of a few kbp can find none and then hangs
both packages' blocks report, ROADMAP Queue 3)."""

import ast
import contextlib
import functools
import io
import pathlib

import numpy as np
import pytest
import torch

import chip_smoke
import torch_jax_native
from csa_tpu import cli as jcli
from csa_tpu import config as jconfig
from csa_tpu_torch import cli, config
from csa_tpu_torch.align import progressive
from csa_tpu_torch.utils import PROFILER

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

REPO = pathlib.Path(__file__).resolve().parent.parent
FULL = (20_000, 8, 7)    # 8 x 20 kbp, seed 7: the full pipeline
R5 = (50_000, 4, 13)     # 4 x 50 kbp, seed 13: mode R
OUTPUTS = ("-Rotated.fasta", "-Aligned.fasta")


@pytest.fixture(autouse=True)
def default_configs():
    """Each test starts and ends with both packages' default RunConfig
    (each CLI installs the one its flags give, for the process)."""
    config.set_run_config(config.RunConfig())
    jconfig.set_run_config(jconfig.RunConfig())
    yield
    config.set_run_config(config.RunConfig())
    jconfig.set_run_config(jconfig.RunConfig())


def _bench_mbp_set():
    """bench.py's ``_mbp_set``, compiled alone: importing bench.py would
    point JAX's compile cache at a directory outside the checkout."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "_mbp_set")
    ns = {}
    exec(compile(ast.Module([fn], []), "bench.py", "exec"), ns)
    return ns["_mbp_set"]


@pytest.mark.parametrize("n,k,seed", [(3_000, 8, 7), (4_000, 4, 13),
                                      FULL, R5])
def test_mbp_set_is_bench_set(n, k, seed):
    want = _bench_mbp_set()(n=n, k=k, seed=seed)
    got = chip_smoke._mbp_set(n, k, seed)
    assert list(want.sizes) == [n] * k
    assert len(got) == k
    for a, b in zip(got, want.encoded_all()):
        assert np.array_equal(a, b)


def test_write_mbp_writes_the_seeded_set(tmp_path):
    path = tmp_path / "s.txt"
    chip_smoke._write_mbp(path, 3_000, 4, 13)
    lines = path.read_text().splitlines()
    rows = chip_smoke._mbp_set(3_000, 4, 13)
    assert lines[0::2] == [f">s{i}" for i in range(4)]
    assert lines[1::2] == ["".join("ACGT"[c] for c in r) for r in rows]
    other = tmp_path / "o.txt"
    chip_smoke._write_mbp(other, 3_000, 4)
    assert other.read_text() != path.read_text()


def _run_cli(main, tmp_path, spec, mode, argv):
    """Write the set ``spec`` into a directory of its own, run ``main``
    there in ``mode`` ([] or ["R"]); returns (console, {suffix: bytes})."""
    work = tmp_path / "_".join(argv).replace("-", "")
    work.mkdir()
    chip_smoke._write_mbp(work / "mbp.txt", *spec)
    log = io.StringIO()
    with contextlib.chdir(work), contextlib.redirect_stdout(log):
        assert main([*mode, "mbp.txt", *argv]) == 0
    text = log.getvalue()
    assert "> Done!" in text
    files = {s: (work / f"mbp{s}").read_bytes() for s in OUTPUTS
             if (work / f"mbp{s}").exists()}
    return text, files


@pytest.fixture(scope="module")
def csa_tpu_full(tmp_path_factory):
    """csa_tpu's full pipeline on the 8 x 20 kbp set, on its jax and
    native routes."""
    tmp = tmp_path_factory.mktemp("jax_full")
    return {route: _run_cli(jcli.main, tmp, FULL, [], ["--backend", route])
            for route in ("jax", "native")}


@pytest.fixture(scope="module")
def csa_tpu_r5(tmp_path_factory):
    """csa_tpu's mode R on the 4 x 50 kbp set, on its jax and native
    routes."""
    tmp = tmp_path_factory.mktemp("jax_r5")
    return {route: _run_cli(jcli.main, tmp, R5, ["R"], ["--backend", route])
            for route in ("jax", "native")}


PORT_ROUTES = [["--backend", "device", "--device", "cpu"],
               ["--backend", "native"]]


@pytest.mark.parametrize("argv", PORT_ROUTES, ids=["device", "native"])
def test_full_pipeline_equals_csa_tpu(tmp_path, csa_tpu_full, argv):
    text, files = _run_cli(cli.main, tmp_path, FULL, [], argv)
    counts = chip_smoke.cascade_counts(text)
    assert counts[3] > 0
    assert "> Checking integrity of aligned sequences... OK" in text
    assert set(files) == set(OUTPUTS)
    for route, (jtext, jfiles) in csa_tpu_full.items():
        assert chip_smoke.cascade_counts(jtext) == counts, route
        assert jfiles == files, route


@pytest.mark.parametrize("argv", PORT_ROUTES, ids=["device", "native"])
def test_rotation_equals_csa_tpu(tmp_path, csa_tpu_r5, argv):
    text, files = _run_cli(cli.main, tmp_path, R5, ["R"], argv)
    counts = chip_smoke.cascade_counts(text)
    assert counts[3] > 0
    for route, (jtext, jfiles) in csa_tpu_r5.items():
        assert chip_smoke.cascade_counts(jtext) == counts, route
        assert jfiles["-Rotated.fasta"] == files["-Rotated.fasta"], route


@pytest.mark.parametrize("dirs_bytes", [None, 1 << 14],
                         ids=["whole", "cut"])
def test_full_pipeline_with_every_merge_on_the_device_fill(
        tmp_path, csa_tpu_full, monkeypatch, dirs_bytes):
    # both gates at 0: the merge gate by its flag, the round gate in the
    # RunConfig the CLI builds
    monkeypatch.setattr(config, "RunConfig", functools.partial(
        config.RunConfig, batch_min_cells=0))
    if dirs_bytes is not None:
        monkeypatch.setattr(progressive, "BATCH_DIRS_BYTES", dirs_bytes)
    giants = []
    real = progressive._partition

    def spy(dev):
        batch, rest = real(dev)
        giants.append(len(rest))
        return batch, rest

    monkeypatch.setattr(progressive, "_partition", spy)
    # --profile turns the profiler on for the process; put it back after
    monkeypatch.setattr(PROFILER, "enabled", False)
    PROFILER.reset()
    text, files = _run_cli(cli.main, tmp_path, FULL, [],
                           PORT_ROUTES[0] + ["--profile",
                                             "--device-min-cells", "0"])
    _, counters = chip_smoke.profile_table(text)
    assert counters["dp_device_dispatches"] > 0
    assert (max(giants) > 0) == (dirs_bytes is not None)
    for route, (_, jfiles) in csa_tpu_full.items():
        assert jfiles == files, route
