"""The port's own copies of the host modules against the JAX package's,
on the CPU and the repository's fixtures: FASTA load and encode, the
rotated FASTA, the block artifacts, the circular plot, the C/S/M tools,
the cyclic index, the host DP pieces and the native host library."""

import contextlib
import io
import pathlib

import numpy as np
import pytest
import torch

from csa_tpu import native as jnative
from csa_tpu.align import anchors as janchors
from csa_tpu.align import progressive as jprogressive
from csa_tpu.index import cyclic as jcyclic
from csa_tpu.io import fasta as jfio
from csa_tpu.report import blocks_report as jblocks
from csa_tpu.report import circular_plot as jplot
from csa_tpu.rotation import pipeline as jrot
from csa_tpu.tools import files as jtools
from csa_tpu_torch import native
from csa_tpu_torch.align import progressive
from csa_tpu_torch.index import cyclic
from csa_tpu_torch.io import fasta as fio
from csa_tpu_torch.report import blocks_report, circular_plot
from csa_tpu_torch.rotation import pipeline as rot
from csa_tpu_torch.tools import files as tools

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SETS = ["Primates", "Mammals", "Set3"]
TINY = sorted(f"tiny/{p.stem}" for p in (FIX / "tiny").glob("*.txt"))
ALIGNED = [f"{s}-Rotated-Aligned" for s in SETS]


def _quiet(fn, *args, **kw):
    """(result, stdout text) of a call."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


@pytest.mark.parametrize("name", SETS + TINY)
def test_fasta_load_and_encode(name):
    path = str(FIX / f"{name}.txt")
    want, wlog = _quiet(jfio.load_fasta, path)
    got, glog = _quiet(fio.load_fasta, path)
    assert glog == wlog
    assert got.names == want.names and got.texts == want.texts
    for g, w in zip(got.encoded_all(), want.encoded_all()):
        np.testing.assert_array_equal(g, w)
    _, wd = _quiet(jfio.discard_duplicate_rotations, want)
    _, gd = _quiet(fio.discard_duplicate_rotations, got)
    assert gd == wd and got.names == want.names


@pytest.mark.parametrize("name", SETS)
def test_rotated_fasta_bytes(name, tmp_path):
    rotated = FIX / f"{name}-Rotated.fasta"
    rotations = [fio.parse_rotated_header(l[1:].strip())[1]
                 for l in rotated.read_text().splitlines()
                 if l.startswith(">")]
    seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    jseqs = jfio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    fio.save_rotated(seqs, rotations, str(tmp_path / "port.fasta"))
    jfio.save_rotated(jseqs, rotations, str(tmp_path / "jax.fasta"))
    assert (tmp_path / "port.fasta").read_bytes() == \
        (tmp_path / "jax.fasta").read_bytes() == rotated.read_bytes()


# the benchmark's Primates inputs: each record turned by a seed
BENCH_PRIMATES = [f"bench-primates-{seed}"
                  for seed in (2**31 + 5, 3 * 2**40 + 1, 3200000300)]


@pytest.mark.parametrize("name", ["Primates", "tiny/t1", "tiny/a-gc-1",
                                  "tiny/a-repeat-0"] + BENCH_PRIMATES)
def test_block_artifacts_bytes(name, tmp_path):
    """-Blocks.csv, -positions.txt, -imagemap.txt and -Blocks.bmp from the
    port's rotation result and writer equal the JAX package's."""
    if name in BENCH_PRIMATES:
        from perfbench.data import rotated_fasta

        src = tmp_path / "Primates.txt"
        rotated_fasta.make({"file": "Primates.txt"},
                           int(name.rsplit("-", 1)[1]), str(src))
    else:
        src = FIX / f"{name}.txt"
    outs = {}
    for tag in ("jax", "port"):
        d = tmp_path / tag
        d.mkdir()
        inp = d / src.name
        inp.write_bytes(src.read_bytes())
        if tag == "jax":
            seqs = jfio.load_fasta(str(inp), log=io.StringIO())
            res = jrot.analyze(seqs, backend="native", log=io.StringIO())
            _, text = _quiet(jblocks.write_blocks_artifacts, str(inp), seqs,
                             res)
        else:
            seqs = fio.load_fasta(str(inp), log=io.StringIO())
            res = rot.analyze(seqs, device="cpu", log=io.StringIO())
            _, text = _quiet(blocks_report.write_blocks_artifacts, str(inp),
                             seqs, res)
        stem = inp.with_suffix("")
        outs[tag] = [text] + [
            pathlib.Path(f"{stem}{suf}").read_bytes()
            for suf in ("-Blocks.csv", "-positions.txt", "-imagemap.txt",
                        "-Blocks.bmp")]
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("name", ALIGNED)
def test_circular_plot_bytes(name, tmp_path):
    src = str(FIX / f"{name}.fasta")
    _, wlog = _quiet(jplot.draw_circular_alignment_plot, src,
                     str(tmp_path / "jax.bmp"))
    _, glog = _quiet(circular_plot.draw_circular_alignment_plot, src,
                     str(tmp_path / "port.bmp"))
    assert glog == wlog
    assert (tmp_path / "port.bmp").read_bytes() == \
        (tmp_path / "jax.bmp").read_bytes()


@pytest.mark.parametrize("shape", [(1, 1), (1, 700), (37, 1), (40, 300),
                                   (402, 1110)])
def test_rle8_encode_bytes(shape):
    """The port's RLE8 encoder against the JAX package's: runs of every
    length across row ends, runs longer than 255, single pixels."""
    from csa_tpu.report.bmp import _rle8_encode as jrle
    from csa_tpu_torch.report.bmp import _rle8_encode

    rng = np.random.default_rng(sum(shape))
    for trial in range(4):
        # run lengths from 1 to 600 over the flat image, values of 0-3
        n = shape[0] * shape[1]
        lens = rng.integers(1, 600 if trial % 2 else 4, size=n)
        vals = rng.integers(0, 4, size=n, dtype=np.uint8)
        img = np.repeat(vals, lens)[:n].reshape(shape)
        assert _rle8_encode(img) == jrle(img), trial


@pytest.mark.parametrize("tool", ["C", "S", "M", "integrity"])
@pytest.mark.parametrize("name", ["Primates", "Set3"])
def test_tool_outputs(tool, name, tmp_path):
    """C on the raw set, S, M and the integrity check on its aligned
    fixture: the printed text and the written file are the JAX
    package's."""
    raw = FIX / f"{name}.txt"
    aligned = FIX / f"{name}-Rotated-Aligned.fasta"
    outs = {}
    for tag, mod in (("jax", jtools), ("port", tools)):
        d = tmp_path / tag
        d.mkdir()
        src = d / (raw.name if tool == "C" else aligned.name)
        src.write_bytes((raw if tool == "C" else aligned).read_bytes())
        if tool == "integrity":
            rotated = d / f"{name}-Rotated.fasta"
            rotated.write_bytes((FIX / rotated.name).read_bytes())
            res, text = _quiet(mod.test_alignment_output, str(rotated),
                               str(src))
            outs[tag] = (res, text)
            continue
        fn = {"C": mod.clean_fasta, "S": mod.sum_of_pairs_score,
              "M": mod.fasta_to_msf}[tool]
        res, text = _quiet(fn, str(src))
        # the MSF header and the log name the file's own path
        written = sorted(p.name for p in d.iterdir() if p != src)
        outs[tag] = (text.replace(str(d), "<dir>"),
                     res if tool == "S" else None,
                     [(n, (d / n).read_bytes().replace(str(d).encode(),
                                                        b"<dir>"))
                      for n in written])
    assert outs["port"] == outs["jax"]


@pytest.mark.parametrize("name", ["tiny/t1", "tiny/a-repeat-1",
                                  "periodic"])
def test_cyclic_index_blocks(name):
    """The exact host cyclic index (the duplicate-rotation branch)."""
    if name == "periodic":
        unit = np.array([0, 1, 2, 3, 1, 0], dtype=np.int64)
        encoded = [np.tile(unit, 6), np.tile(unit, 5)[3:],
                   np.roll(np.tile(unit, 7), 4)]
    else:
        seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
        encoded = seqs.encoded_all()
    got = cyclic.collect_blocks(cyclic.build_rotation_index(encoded))
    want = jcyclic.collect_blocks(jcyclic.build_rotation_index(encoded))
    for f in ("start", "end", "depth"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(cyclic.remove_suffix_blocks(got),
                                  jcyclic.remove_suffix_blocks(want))
    gu, gp = got.positions_if_unique()
    wu, wp = want.positions_if_unique()
    np.testing.assert_array_equal(gu, wu)
    np.testing.assert_array_equal(gp, wp)


def _gap_inputs(seed):
    rng = np.random.default_rng(seed)
    R, C, i = int(rng.integers(1, 60)), int(rng.integers(1, 60)), \
        int(rng.integers(1, 9))
    row = rng.integers(0, 4, size=R).astype(np.int64)
    sv = rng.multinomial(i, [0.2] * 5, size=C).astype(np.int64)
    return row, sv, i


@pytest.mark.parametrize("seed", range(4))
def test_host_dp_fill_and_maps(seed):
    """The DP fill and the path maps of the port's
    progressive module equal the JAX package's."""
    row, sv, i = _gap_inputs(seed)
    top = progressive.default_top_row(sv, i)
    np.testing.assert_array_equal(top, jprogressive.default_top_row(sv, i))
    g_score, g_dirs = progressive.dp_fill(row, sv, i, top_row=top,
                                          edge_rowgap=-i)
    w_score, w_dirs = jprogressive.dp_fill(row, sv, i, top_row=top,
                                           edge_rowgap=-i)
    assert g_score == w_score
    np.testing.assert_array_equal(g_dirs, w_dirs)
    g_maps = progressive._dirs_to_maps(g_dirs, len(row), len(sv))
    w_maps = jprogressive._dirs_to_maps(w_dirs, len(row), len(sv))
    for g, w in zip(g_maps, w_maps):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("seed", range(3))
def test_native_pairwise_nw(seed):
    rng = np.random.default_rng(seed)
    for _ in range(5):
        a = rng.integers(0, 4, size=int(rng.integers(1, 300)))
        b = rng.integers(0, 4, size=int(rng.integers(1, 300)))
        assert native.pairwise_nw(a, b) == jnative.pairwise_nw(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_native_dp_fill_path(seed):
    row, sv, i = _gap_inputs(100 + seed)
    rng = np.random.default_rng(seed)
    top = rng.integers(-60, 10, size=len(sv) + 1)
    erg = int(rng.integers(-20, 0))
    g = native.dp_fill_path(row, sv, i, top, erg)
    w = jnative.dp_fill_path(row, sv, i, top, erg)
    assert g[0] == w[0]
    np.testing.assert_array_equal(g[1], w[1])


@pytest.mark.parametrize("name", ["tiny/t3", "tiny/a-diverge-1"])
def test_native_anchor_attach(name):
    seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    idx = janchors.build_linear_index(seqs.encoded_all(), backend="numpy")
    g = native.anchor_attach(idx.seq_of, idx.lcp, idx.cap, idx.num_seqs)
    w = jnative.anchor_attach(idx.seq_of, idx.lcp, idx.cap, idx.num_seqs)
    for x, y in zip(g, w):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", range(4))
def test_native_dgc(seed):
    """DeleteGappedColumns through both native libraries on a seeded
    gappy profile: the same consensus size, strings and counts."""
    rng = np.random.default_rng(seed)
    numseqs, consize = 5, int(rng.integers(20, 80))
    base = rng.integers(0, 4, size=(numseqs, consize)).astype(np.int8)
    gaps = rng.random((numseqs, consize)) < 0.45
    base[gaps] = 4
    sv = np.zeros((consize, 5), dtype=np.int64)
    for t in range(numseqs):
        np.add.at(sv, (np.arange(consize), base[t].astype(np.int64)), 1)
    outs = []
    for lib in (native, jnative):
        strings = [row.copy() for row in base]
        svc = sv.copy()
        n = lib.dgc(list(range(numseqs)), strings, numseqs, svc, consize,
                    (numseqs + 1) // 2)
        outs.append((n, np.stack(strings), svc))
    assert outs[0][0] == outs[1][0]
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    np.testing.assert_array_equal(outs[0][2], outs[1][2])
