"""The ``set3`` configuration: its maker is seeded like the others, its
data is the fixture, and the plain reference writes what the C tool
and the JAX package write on it.  On four records of Set3 the reference
writes what the port's host routes write.  The full-size Set3 checks
take minutes (``-m slow``)."""

import os
import shutil
import subprocess
import sys

import pytest

from conftest import FIX, ROOT
from perfbench import manifest, outputs
from perfbench.reference import pipeline
from test_data import SEEDS, _config, _make, _records
from test_reference import _made, _read, _run, _sha256

# sha256 of the JAX package's outputs for Set3 turned by the seed
# 2**31 + 5, taken with
#   python -m csa_tpu.cli set.txt --backend native
# on the CPU (the tests import nothing of that package)
WITNESS_N = {
    "-Rotated.fasta": "053aa97048357a46a43a91468cc5d554"
                      "c71e8036ded8feadb018585d94162fd1",
    "-Blocks.csv": "fdee5c1fb6d13afd4f6b7d6b506ca4c2"
                   "ba1ec35b800602f3f89cb6a448cdba0a",
    "-positions.txt": "cfe46cec3112c32b9b002f6e9eaee20a"
                      "8e4fae1c20d3fbc0357777b1ad35f596",
    "-imagemap.txt": "c522f57e8269f35c6c8c6f164b513969"
                     "1b70d40919096f0d66b746adbd5f8da9",
    "-Blocks.bmp": "b4ba8f7199431240ef3693124ea36cfa"
                   "a1213f75c7c6032674f723cd0e1169e7",
    "-Aligned.fasta": "63a5ec9ddfb9fc2983b2363eec81577e"
                      "f2e91193eb38dadabcd69ecfcc28fe77",
    "-CircularAlignment.bmp": "cae15b82f277c539d4883423c18cf901"
                              "d8b297df5dbaf9e7beb9c100b55f73e4",
}

# four records of Set3, two of the Primates 16 and two of its outgroups:
# three gaps and 5.05e8 DP cells, seconds on a CPU
SUBSET = ("NC_001643", "NC_001807", "NC_001323", "NC_001709")


def test_set3_same_seed_same_bytes_other_seed_other_input(tmp_path):
    runs = [_make("set3", s, str(tmp_path / f"{i}.txt"))
            for i, s in enumerate(SEEDS + SEEDS[:1])]
    assert runs[0] == runs[-1]
    assert len({r for r in runs[:-1]}) == len(SEEDS)
    lengths = {tuple(len(b) for _, b in _records(r)) for r in runs}
    assert len(lengths) == 1


def test_set3_maker_turns_each_record(tmp_path):
    from perfbench.data import rotated_fasta

    want = rotated_fasta.read_records(os.path.join(ROOT, "perfbench", "data",
                                                   "Set3.txt"))
    got = _records(_make("set3", 11, str(tmp_path / "s.txt")))
    cfg = _config("set3")
    assert [n for n, _ in got] == [n for n, _ in want]
    assert len(want) == cfg["sequences"]
    assert sum(len(b) for _, b in want) == cfg["total_bp"]
    for (_, b), (_, w) in zip(got, want):
        assert len(b) == len(w) and b in w + w


def test_set3_copy_is_the_fixture():
    name = _config("set3")["params"]["file"]
    with open(os.path.join(ROOT, "perfbench", "data", name), "rb") as f, \
            open(os.path.join(FIX, name), "rb") as g:
        assert f.read() == g.read()


def _subset(tmp_path, seed):
    """The records ``SUBSET`` of Set3, in its order, turned by the
    ``rotated_fasta`` maker at ``seed``."""
    maker = manifest.maker({"maker": "rotated_fasta"})
    records = maker.read_records(os.path.join(ROOT, "perfbench", "data",
                                              "Set3.txt"))
    src = tmp_path / "subset.fa"
    with open(src, "w") as f:
        for name, body in records:
            if name in SUBSET:
                f.write(f">{name}\n{body}\n")
    path = str(tmp_path / "set.txt")
    maker.make({"file": str(src)}, seed, path)
    return path


def test_set3_subset_as_the_port_host_routes_write(tmp_path):
    inp = _subset(tmp_path, 2**31 + 5)
    got = {}
    for route in ("reference", "native", "numpy"):
        d = tmp_path / route
        d.mkdir()
        shutil.copy(inp, d / "set.txt")
        if route == "reference":
            pipeline.run("N", str(d / "set.txt"))
        else:
            proc = subprocess.run(
                [sys.executable, "-m", "csa_tpu_torch.cli", "set.txt",
                 "--backend", route], cwd=d,
                env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                text=True, timeout=600)
            assert proc.returncode == 0, proc.stdout[-3000:]
        got[route] = outputs.digests(str(d), "set.txt")
    assert set(got["reference"]) == set(outputs.KINDS)
    assert got["native"] == got["reference"]
    assert got["numpy"] == got["reference"]


@pytest.mark.slow
def test_set3_rotation_and_alignment(tmp_path):
    # two gaps of up to 16,979 x 20,852: minutes on a CPU
    base = _run(tmp_path, os.path.join(FIX, "Set3.txt"))
    assert _read(base + "-Rotated.fasta") == \
        _read(os.path.join(FIX, "Set3-Rotated.fasta"))

    def rows(path):
        return [line for line in _read(path).decode().splitlines()
                if not line.startswith(">")]

    # the fixture was written by the C tool's mode A on the rotated file,
    # so only its headers differ from a full run's
    assert rows(base + "-Aligned.fasta") == \
        rows(os.path.join(FIX, "Set3-Rotated-Aligned.fasta"))


@pytest.mark.slow
def test_set3_rotated_input_as_the_jax_package_writes(tmp_path):
    path = _made(tmp_path, "set3", 2**31 + 5)
    pipeline.run("N", path)
    got = {name[len("set"):]: _sha256(str(tmp_path / name))
           for name in os.listdir(tmp_path) if name != "set.txt"}
    assert got == WITNESS_N
