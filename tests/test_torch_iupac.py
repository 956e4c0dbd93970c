"""Code-4 rows in the gap DP: IUPAC characters (N, R, Y, ...) that the
loader keeps but codes as 4.

The contract is the JAX package's device route (``dp_backend="jax"``
with both routing gates at 0, so every merge takes it): code 4 scores as
"no count" of the profile column.  The JAX package's native route reads
past its per-code table on such rows and its numpy route raises, so
neither is held here.  The port's CPU run, its native host fill and its
numpy twin are held to that route: the aligned FASTA byte for byte, and
the fills cell for cell against the kernels' plain version."""

import ctypes
import io

import numpy as np
import pytest
import torch

from csa_tpu.align import runner as jrunner
from csa_tpu.io import fasta as jfio
from csa_tpu.rotation import pipeline as jrot
from csa_tpu_torch import native
from csa_tpu_torch.align import progressive, runner
from csa_tpu_torch.dp import profile
from csa_tpu_torch.io import fasta as tfio
from csa_tpu_torch.rotation import pipeline as rot

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

# the code-4 set of the differential run that found the fault
CODE4_SET = """>s0
TCCGCAATTAGTACTACACTATCTAGCAAACTCC
>s1
GCCAGCTCCTCCGGAATTCGTCCTCACTTCGCGACCTA
>s2
CCGCGTTATGGATCTAATGAGCAAACTCGTCCTTCCAGAATTTGTCCAACACTACCTTAAT
>s3
NGCCCTTCGATTCGGNAGTYTTAGCRAACTTGTCCTACACTAG
"""
IUPAC = "RYSWKMDHBVN"


def _aligned(src, tmp_path, tag):
    """Rotate and align ``src`` with the JAX package's device route
    (``tag == "jax"``) or the port on the CPU; the aligned file's bytes."""
    fio = jfio if tag == "jax" else tfio
    seqs = fio.load_fasta(str(src), log=io.StringIO())
    if tag == "jax":
        res = jrot.analyze(seqs, backend="jax", log=io.StringIO())
    else:
        res = rot.analyze(seqs, device="cpu", log=io.StringIO())
    codes = [np.roll(e, -int(r))
             for e, r in zip(seqs.encoded_all(), res.rotations)]
    if tag == "jax":
        result = jrunner.run_alignment(codes, dp_backend="jax",
                                       log=io.StringIO())
        save = jrunner.save_alignment
    else:
        result = runner.run_alignment(codes, device="cpu", log=io.StringIO())
        save = runner.save_alignment
    out = tmp_path / f"{src.stem}-{tag}.fasta"
    save(str(out), result, codes, seqs.names, res.rotations,
         log=io.StringIO())
    return out.read_bytes()


@pytest.fixture
def device_route(monkeypatch):
    """Every merge of the JAX package on its device route."""
    monkeypatch.setenv("CSA_TPU_DEVICE_MIN_CELLS", "0")
    monkeypatch.setenv("CSA_TPU_BATCH_MIN_CELLS", "0")


def test_code4_set_matches_jax_device_route(device_route, tmp_path):
    src = tmp_path / "code4.txt"
    src.write_text(CODE4_SET)
    want = _aligned(src, tmp_path, "jax")
    assert _aligned(src, tmp_path, "torch") == want


def _random_set(seed, iupac):
    """3-4 rotated, mutated copies of one random sequence of 40-90 bp;
    with ``iupac`` about one base in eight becomes an IUPAC letter."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(40, 90))
    base = rng.choice(list("ACGT"), size=n)
    rows = []
    for _ in range(int(rng.integers(3, 5))):
        row = list(np.roll(base, int(rng.integers(0, n))))
        for _ in range(n // 12):
            p = int(rng.integers(0, len(row)))
            op = rng.integers(0, 3)
            if op == 0:
                row[p] = str(rng.choice(list("ACGT")))
            elif op == 1:
                del row[p]
            else:
                row.insert(p, str(rng.choice(list("ACGT"))))
        if iupac:
            for p in np.flatnonzero(rng.random(len(row)) < 0.125):
                row[p] = str(rng.choice(list(IUPAC)))
        rows.append("".join(row))
    return "".join(f">s{k}\n{r}\n" for k, r in enumerate(rows))


@pytest.mark.parametrize("seed,iupac", [(1, False), (2, False), (3, True),
                                        (4, True)])
def test_seeded_sets_match_jax_device_route(device_route, tmp_path, seed,
                                            iupac):
    src = tmp_path / f"set{seed}.txt"
    src.write_text(_random_set(seed, iupac))
    want = _aligned(src, tmp_path, "jax")
    assert _aligned(src, tmp_path, "torch") == want


def _gap(seed, R, C, i):
    """One merge's fill inputs with code-4 rows (a quarter of them), a
    stale top row and a stale edge."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(5, size=R, p=[0.1875] * 4 + [0.25]).astype(np.int8)
    sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
    top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
    return codes, sv, i, top, int(rng.integers(-20, 0))


@pytest.fixture
def two_threads(request):
    """Force the native fill's two-thread split (C >= 4096) or leave it
    single-threaded."""
    lib = native._load()
    assert lib is not None, "the port's native host library did not build"
    if request.param:
        lib.csa_set_mt_threshold(ctypes.c_longlong(1))
    yield request.param
    lib.csa_set_mt_threshold(ctypes.c_longlong(0))


@pytest.mark.parametrize("two_threads", [False, True], indirect=True,
                         ids=["one_thread", "two_threads"])
def test_native_fill_code4_matches_plain(two_threads):
    """The port's native fill and walk on code-4 rows against the kernels'
    plain version (the path) and the numpy twin (every direction)."""
    codes, sv, i, top, erg = _gap(7, 150, 4100 if two_threads else 700, 9)
    score, path = native.dp_fill_path(codes, sv, i, top, erg)
    want = profile.profile_path(codes, sv, i, top, erg, device="cpu")
    np.testing.assert_array_equal(path, want)
    score_d, dirs = native.dp_fill_dirs(codes, sv, i, top, erg)
    assert score_d == score


def test_numpy_twin_code4_matches_native(monkeypatch):
    """progressive.dp_fill without the native library (its numpy twin)
    gives the native fill's directions and score on code-4 rows."""
    codes, sv, i, top, erg = _gap(8, 90, 120, 6)
    want = native.dp_fill_dirs(codes, sv, i, top, erg)
    monkeypatch.setattr(native, "dp_fill_dirs", lambda *a, **k: None)
    got = progressive.dp_fill(codes.astype(np.int64), sv, i, top_row=top,
                              edge_rowgap=erg)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
