"""The sharded rotation on the port's CLI: ``--backend sharded`` at meshes
of 1-8 ranks on the CPU, modes R and N, byte for byte against the port's
single-device run on two seeded sets; the port's block stage over a mesh
against the JAX package's ``rotation_final_jax(mesh=...)`` on its virtual
CPU mesh (the ladder on power-of-two meshes, its GSPMD route on 3 x 1);
and ``parallel.scaling.measure`` at a small size."""

import contextlib
import io
import json
import os
import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from csa_tpu.index import engine as jengine
from csa_tpu_torch import cli
from csa_tpu_torch.index import engine
from csa_tpu_torch.io import fasta as fio
from csa_tpu_torch.parallel import scaling
from csa_tpu_torch.parallel.sharded import make_mesh
from csa_tpu_torch.utils import PROFILER

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

MESHES = [(1, 1), (2, 1), (4, 1), (8, 1), (4, 2), (3, 1)]


def _family(seed, k=6, n=360):
    """k rotated, mutated copies of one random sequence."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n)
    rows = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=n // 40)
        row[idx] = rng.integers(0, 4, size=len(idx))
        rows.append(row)
    return rows


def _ragged(seed, k=6):
    """Copies of one sequence cut to different lengths by deletions."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=420)
    rows = []
    for _ in range(k):
        keep = np.ones(len(base), bool)
        keep[rng.integers(0, len(base), size=int(rng.integers(0, 80)))] = 0
        rows.append(np.roll(base[keep], int(rng.integers(0, 300))))
    return rows


SETS = {"family": lambda: _family(1), "ragged": lambda: _ragged(2)}


def _write(path, rows):
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    path.write_text("".join(f">s{i}\n{letters[r].tobytes().decode()}\n"
                            for i, r in enumerate(rows)))


def _run(tmp, name, mode, extra=()):
    """Run the port's CLI in a fresh directory; returns (outputs, stdout)."""
    tmp.mkdir()
    _write(tmp / f"{name}.txt", SETS[name]())
    argv = ([] if mode == "N" else [mode]) + [f"{name}.txt", "--device",
                                              "cpu", "--profile", *extra]
    out = io.StringIO()
    PROFILER.reset()
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(argv) == 0
    finally:
        os.chdir(cwd)
        PROFILER.reset()
    files = {p.name: p.read_bytes() for p in sorted(tmp.iterdir())}
    return files, out.getvalue()


@pytest.fixture(scope="module")
def single(tmp_path_factory):
    base = tmp_path_factory.mktemp("single")
    return {(name, mode): _run(base / f"{name}-{mode}", name, mode)[0]
            for name in SETS for mode in ("R", "N")}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("mode", ["R", "N"])
@pytest.mark.parametrize("name", list(SETS))
def test_cli_sharded_is_byte_identical(single, tmp_path, name, mode, mesh):
    shape = f"{mesh[0]}x{mesh[1]}"
    files, text = _run(tmp_path / "run", name, mode,
                       ["--backend", "sharded", "--mesh", shape])
    want = single[name, mode]
    assert sorted(files) == sorted(want)
    for fname, data in want.items():
        assert files[fname] == data, fname
    phases = {line.split()[1] for line in text.splitlines()
              if line.startswith(">   ")}
    assert "rot.block_stage[sharded]" in phases
    D = mesh[0] * mesh[1]
    # the ladder on a power-of-two rank count, the single-device stage on
    # the first rank otherwise
    assert ("idx.replicate" in phases) == (D & (D - 1) == 0)
    moved = [float(line.split()[-1]) for line in text.splitlines()
             if line.startswith("> [profile] rank_exchange_bytes:")]
    if D > 1 and D & (D - 1) == 0:
        assert moved and moved[0] > 0
    else:
        assert not any(moved)


@pytest.fixture(scope="module")
def family():
    return [np.asarray(r, dtype=np.int64) for r in _family(1)]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_block_stage_matches_jax_mesh(family, mesh):
    n = mesh[0] * mesh[1]
    jmesh = JaxMesh(np.asarray(jax.devices()[:n]).reshape(mesh),
                    ("seq", "pos"))
    want = jengine.rotation_final_jax(family, mesh=jmesh)
    got = engine.rotation_final(family, "cpu", mesh=make_mesh(
        shape=mesh, devices=[torch.device("cpu")]))
    assert (got.num_collected, got.num_after_suffix) == \
        (want.num_collected, want.num_after_suffix)
    np.testing.assert_array_equal(got.final_start, want.final_start)
    np.testing.assert_array_equal(got.final_depth, want.final_depth)
    np.testing.assert_array_equal(got.final_positions, want.final_positions)


def test_sharded_analyze_matches_single_device():
    from csa_tpu_torch.rotation import pipeline

    path = pathlib.Path(__file__).resolve().parent / "fixtures" / "tiny"
    s = fio.load_fasta(str(path / "a-diverge-0.txt"), log=io.StringIO())
    want = pipeline.analyze(s, device="cpu", log=io.StringIO())
    got = pipeline.analyze(s, device="cpu", log=io.StringIO(),
                           mesh=make_mesh(4, devices=["cpu"]))
    np.testing.assert_array_equal(got.rotations, want.rotations)
    assert (got.num_collected, got.num_after_suffix, got.num_after_unique,
            got.num_chains) == (want.num_collected, want.num_after_suffix,
                                want.num_after_unique, want.num_chains)


def test_scaling_measure_small():
    r = scaling.measure(k=4, n=3000, ranks=(1, 2, 4), reps=1, device="cpu",
                        giant=(150, 200))
    json.dumps(r)
    assert r["device"] == "cpu"
    assert set(r["walls_s"]) == set(r["stage_walls_s"]) == {1, 2, 4}
    assert {"idx.refine", "idx.collect_front"} <= set(
        r["single_device_stage_walls_s"])
    for phases in r["stage_walls_s"].values():
        assert {"idx.pack", "idx.l0_sort", "idx.lcp", "idx.replicate",
                "idx.collect_front", "idx.collect_tail"} <= set(phases)
    assert r["exchange_bytes"][1] == 0
    assert 0 < r["exchange_bytes"][2] < r["exchange_bytes"][4]
    assert set(r["peer_copy_bytes"].values()) == {0}
    assert r["cascade_parity_across_ranks"]
    assert r["argsort"]["exact_vs_stable_sort"]
    assert r["sharded_alignment_parity"]
    assert r["giant_merge_seqpar"]["path_identical_to_native"]
    assert set(r["jax_model"]["per_device_sort_bytes"]) == {1, 2, 4}



def test_duplicate_rotations_take_the_host_path_over_a_mesh(tmp_path):
    """A periodic sequence has duplicate rotations: the ladder returns
    None over the mesh as the single-device build does, and analyze
    takes the exact host index either way, with the same result."""
    from csa_tpu_torch.rotation import pipeline

    rng = np.random.default_rng(6)
    unit = "".join("ACGT"[c] for c in rng.integers(0, 4, size=9)) * 8
    tail = "".join("ACGT"[c] for c in rng.integers(0, 4, size=60))
    (tmp_path / "p.txt").write_text(
        f">p\n{unit}\n>q\n{unit[5:]}{unit[:5]}{tail}\n")
    seqs = fio.load_fasta(str(tmp_path / "p.txt"), log=io.StringIO())
    mesh = make_mesh(4, devices=["cpu"])
    assert engine.rotation_final(seqs.encoded_all(), "cpu", mesh=mesh) \
        is None
    want = pipeline.analyze(seqs, device="cpu", log=io.StringIO())
    got = pipeline.analyze(seqs, device="cpu", log=io.StringIO(), mesh=mesh)
    np.testing.assert_array_equal(got.rotations, want.rotations)
    assert got.index is not None
    assert (got.num_collected, got.num_after_suffix, got.num_chains) == \
        (want.num_collected, want.num_after_suffix, want.num_chains)
