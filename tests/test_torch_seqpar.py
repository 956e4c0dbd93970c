"""The port's sharded gap DP (csa_tpu_torch.parallel.sharded, dp.band,
dp.seqpar, profile_paths_sharded and progressive_dp_batched with a mesh)
against the JAX package on its virtual 8-device CPU mesh, at the sizes of
tests/test_seqpar.py.  The port's meshes here are 1-8 ranks on the one
CPU device, so every band runs the plain version; the CUDA band kernel
is held against it on the card (tests/test_torch_cuda.py, chip_smoke.py).
Directions and paths are integer codes: every comparison is exact."""

import pathlib

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from csa_tpu import config
from csa_tpu.align import progressive as jprogressive
from csa_tpu.dp import pallas_band, wavefront
from csa_tpu.dp import seqpar as jseqpar
from csa_tpu_torch import cli
from csa_tpu_torch.align import progressive
from csa_tpu_torch.dp import band, profile, seqpar
from csa_tpu_torch.parallel import sharded
from csa_tpu_torch.parallel.sharded import make_mesh, relabel

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
NON_DEFAULT = config.Scoring(match=2, mismatch=-3, indel=-2, doublegap=-1)


def _jmesh(n, axis="col"):
    return JaxMesh(np.asarray(jax.devices()[:n]), (axis,))


def _cpu_mesh(n):
    return make_mesh(n, devices=[torch.device("cpu")])


def _sc(s):
    return dict(match=s.match, mismatch=s.mismatch, indel=s.indel,
                doublegap=s.doublegap)


def _gap(rng, rlo, rhi, clo, chi, ihi):
    R = int(rng.integers(rlo, rhi))
    C = int(rng.integers(clo, chi))
    i = int(rng.integers(1, ihi))
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
    return codes, sv, i


@pytest.fixture
def jax_scoring():
    """Install a scoring into the JAX package for one test (its seqpar
    and pallas_band read the global)."""
    def install(s):
        config.set_scoring(s)
    yield install
    config.set_scoring(config.DEFAULT_SCORING)


# -- the mesh ---------------------------------------------------------------

@pytest.mark.parametrize("n,shape", [(1, (1, 1)), (6, (3, 2)), (8, (4, 2)),
                                     (7, (7, 1))])
def test_factor_mesh_matches_jax(n, shape):
    from csa_tpu.parallel import sharded as jsharded

    assert sharded._factor_mesh(n) == jsharded._factor_mesh(n) == shape


def test_make_mesh_lays_ranks_round_robin_and_relabels():
    a, b = torch.device("cpu"), torch.device("meta")
    mesh = make_mesh(shape=(3, 1), devices=[a, b])
    assert mesh.devices == (a, b, a) and mesh.size == 3
    assert mesh.shape == (3, 1) and mesh.axis == ("seq", "pos")
    col = relabel(mesh, "col")
    assert col.devices == mesh.devices and col.shape == (3,)
    assert col.axis == ("col",)
    assert make_mesh(devices=[a]).size == 1
    assert make_mesh(8, devices=[a]).shape == (4, 2)
    with pytest.raises(ValueError):
        make_mesh(4, shape=(3, 1), devices=[a])
    assert sharded.rank_streams(mesh) == [None, None, None]


@pytest.mark.parametrize("n_items,n_ranks,want", [
    (11, 4, [(0, 4), (4, 8), (8, 11), (11, 11)]),
    (11, 8, [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10), (10, 11), (11, 11),
             (11, 11)]),
    (3, 2, [(0, 3), (3, 3)]),
    (9, 3, [(0, 6), (6, 9), (9, 9)]),
])
def test_rank_chunks_cut_as_the_jax_gap_shard(n_items, n_ranks, want):
    got = profile.rank_chunks(n_items, n_ranks)
    assert [(s.start, s.stop) for s in got] == want


# -- one band ---------------------------------------------------------------

def _band_inputs(codes, sv, i, rows, cols, top, left, sc):
    colsub, cg, rowgap = profile._channels(
        torch.from_numpy(sv[cols])[None], torch.tensor([i]), **sc)
    return (torch.from_numpy(codes[rows]), colsub[0].to(torch.int32),
            cg[0].to(torch.int32), int(rowgap[0]),
            torch.as_tensor(top, dtype=torch.int32),
            torch.as_tensor(left, dtype=torch.int32))


@pytest.mark.parametrize("scoring", ["default", "non_default"])
def test_band_fill_plain_matches_dp_fill(scoring, jax_scoring):
    """Four bands tiling a matrix (2 row bands x 2 column ranks), chained
    through their bottom rows and right edges as seqpar chains them, equal
    the blocks of the JAX package's full dp_fill direction matrix."""
    s = config.DEFAULT_SCORING if scoring == "default" else NON_DEFAULT
    jax_scoring(s)
    rng = np.random.default_rng(21)
    R, C, i, Rb, Cloc = 50, 70, 5, 23, 40   # row bands 23 + 27; ranks 40 + 30
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, 3, size=(C, 5)).astype(np.int64)
    top = jprogressive.default_top_row(sv, i)
    _, want = jprogressive.dp_fill(codes, sv, i)
    sc = _sc(s)
    bottoms = {}
    for b, rows in enumerate([slice(0, Rb), slice(Rb, R)]):
        edge = None
        for d, cols in enumerate([slice(0, Cloc), slice(Cloc, C)]):
            t = top[cols.start: cols.stop + 1] if b == 0 else bottoms[d]
            left = (np.arange(rows.start + 1, rows.stop + 1) * s.indel * i
                    if d == 0 else edge)
            dirs, bottom, edge = band.band_fill_plain(
                *_band_inputs(codes, sv, i, rows, cols, t, left, sc))
            bottoms[d] = bottom
            got = band.unpack_dirs(dirs, rows.stop - rows.start,
                                   cols.stop - cols.start)
            np.testing.assert_array_equal(
                got.numpy(), want[rows.start + 1: rows.stop + 1,
                                  cols.start + 1: cols.stop + 1])
            # the carried row keeps the left boundary at index 0, and the
            # bottom row and right edge meet in the corner cell
            assert int(bottom[0]) == int(left[-1])
            assert int(bottom[-1]) == int(edge[-1])


def test_band_fill_cpu_writes_into_out_and_rejects_other_devices():
    rng = np.random.default_rng(4)
    codes, sv, i = _gap(rng, 9, 10, 13, 14, 4)
    top = profile.default_top_row(sv, i, indel=-1, doublegap=0)
    args = _band_inputs(codes, sv, i, slice(0, 9), slice(0, 13), top,
                        -i * np.arange(1, 10), _sc(config.DEFAULT_SCORING))
    want = band.band_fill_plain(*args)
    out = (torch.empty(band.dirs_bytes(9, 13), dtype=torch.uint8),
           torch.empty(14, dtype=torch.int32),
           torch.empty(9, dtype=torch.int32))
    got = band.band_fill(*args, out=out)
    assert all(g is o for g, o in zip(got, out))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        band.band_fill(args[0].to("meta"), *args[1:])


# -- the column-sharded fill and path ---------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_dp_fill_seqpar_matches_jax(n_dev):
    rng = np.random.default_rng(n_dev)
    codes, sv, i = _gap(rng, 30, 300, 50, 500, 7)
    want = jseqpar.dp_fill_seqpar(codes, sv, i, mesh=_jmesh(n_dev),
                                  band_rows=16)
    got = seqpar.dp_fill_seqpar(codes, sv, i, _cpu_mesh(n_dev), band_rows=16,
                                **_sc(config.DEFAULT_SCORING))
    np.testing.assert_array_equal(got, want)


def test_dp_fill_seqpar_non_default_scoring_stale_top(jax_scoring):
    rng = np.random.default_rng(42)
    codes, sv, i = _gap(rng, 120, 121, 200, 201, 5)
    top = rng.integers(-500, 500, size=len(sv) + 1).astype(np.int64)
    jax_scoring(NON_DEFAULT)
    want = jseqpar.dp_fill_seqpar(codes, sv, i, mesh=_jmesh(8), band_rows=8,
                                  top_row=top, edge_rowgap=-7)
    got = seqpar.dp_fill_seqpar(codes, sv, i, _cpu_mesh(8), band_rows=8,
                                top_row=top, edge_rowgap=-7,
                                **_sc(NON_DEFAULT))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_dp_path_seqpar_matches_band_pallas(n_dev):
    rng = np.random.default_rng(100 + n_dev)
    codes, sv, i = _gap(rng, 40, 200, 60, 300, 9)
    want = pallas_band.dp_path_band_pallas(codes, sv, i, mesh=_jmesh(n_dev),
                                           band_rows=32, interpret=True)
    got = seqpar.dp_path_seqpar(codes, sv, i, _cpu_mesh(n_dev), band_rows=32,
                                **_sc(config.DEFAULT_SCORING))
    np.testing.assert_array_equal(got, want)


def test_dp_path_seqpar_stale_non_default_matches_jax(jax_scoring):
    rng = np.random.default_rng(23)
    codes, sv, i = _gap(rng, 70, 71, 180, 181, 7)
    top = rng.integers(-500, 500, size=len(sv) + 1).astype(np.int64)
    jax_scoring(NON_DEFAULT)
    want = jseqpar.dp_path_seqpar(codes, sv, i, mesh=_jmesh(4), band_rows=32,
                                  top_row=top, edge_rowgap=-11)
    got = seqpar.dp_path_seqpar(codes, sv, i, _cpu_mesh(4), band_rows=32,
                                top_row=top, edge_rowgap=-11,
                                **_sc(NON_DEFAULT))
    np.testing.assert_array_equal(got, want)


def test_dp_path_seqpar_one_rank_takes_the_profile_path(monkeypatch):
    rng = np.random.default_rng(3)
    codes, sv, i = _gap(rng, 20, 40, 20, 40, 4)
    monkeypatch.setattr(seqpar, "fill_blocks", None)  # must not be reached
    got = seqpar.dp_path_seqpar(codes, sv, i, _cpu_mesh(1))
    np.testing.assert_array_equal(
        got, profile.profile_path(codes, sv, i, device="cpu"))


# -- the gap-axis batch -----------------------------------------------------

def _items(rng, n=11):
    items = []
    for _ in range(n):  # odd count: ranks get unequal shares
        codes, sv, i = _gap(rng, 5, 120, 5, 150, 6)
        top = jprogressive.default_top_row(sv, i)
        items.append((codes, sv, i, top, -i))
    return items


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_profile_paths_sharded_matches_jax(n_dev):
    items = _items(np.random.default_rng(5))
    want = wavefront.dp_paths_device_sharded(items, mesh=_jmesh(n_dev, "gap"))
    got = profile.profile_paths_sharded(items, _cpu_mesh(n_dev))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


# -- progressive_dp_batched with a mesh ---------------------------------------

def _spy(monkeypatch, module, name):
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _mixed_gaps(rng):
    return [[rng.integers(0, 4, size=int(rng.integers(lo, hi)))
             .astype(np.int8) for _ in range(4)]
            for lo, hi in [(20, 60), (30, 70), (150, 260), (180, 240)]]


def test_progressive_mesh_matches_jax(monkeypatch):
    """The same cap in both packages: the same merges go to seqpar (spies),
    the rest as rank-split batches or single merges; the strings equal the
    JAX package's and the port's own single-device route."""
    gaps = _mixed_gaps(np.random.default_rng(11))
    cap = 8 * (100 + 512) * (100 + 512)
    monkeypatch.setattr(jprogressive, "BATCH_DIRS_CAP", cap)
    monkeypatch.setattr(progressive, "BATCH_DIRS_CAP", cap)
    jgiants = _spy(monkeypatch, jseqpar, "dp_path_seqpar")
    giants = _spy(monkeypatch, seqpar, "dp_path_seqpar")
    batches = _spy(monkeypatch, profile, "profile_paths_sharded")
    want = jprogressive.progressive_dp_batched(
        [[g.copy() for g in gs] for gs in gaps],
        mesh=JaxMesh(np.asarray(jax.devices()), ("gap",)))
    got = progressive.progressive_dp_batched(
        [[g.copy() for g in gs] for gs in gaps], device="cpu",
        mesh=_cpu_mesh(8))
    assert len(giants) == len(jgiants) > 0
    assert len(batches) > 0
    single = progressive.progressive_dp_batched(
        [[g.copy() for g in gs] for gs in gaps], device="cpu")
    for gw, gg, gs in zip(want, got, single):
        for a, b, c in zip(gw, gg, gs):
            np.testing.assert_array_equal(b, a)
            np.testing.assert_array_equal(b, c)


def test_progressive_mesh_keeps_the_byte_rule_without_a_mesh(monkeypatch):
    """The JAX cap applies only with a mesh: without one, a cap of 1 sends
    nothing to seqpar."""
    gaps = _mixed_gaps(np.random.default_rng(2))[:2]
    monkeypatch.setattr(progressive, "BATCH_DIRS_CAP", 1)
    giants = _spy(monkeypatch, seqpar, "dp_path_seqpar")
    progressive.progressive_dp_batched(gaps, device="cpu")
    assert giants == []


# -- the CLI ----------------------------------------------------------------

@pytest.mark.parametrize("name", ["t1", "a-diverge-0"])
def test_cli_sharded_matches_jax_numpy_backend(name, tmp_path, monkeypatch):
    """Mode A on a rotated tiny set: the port with --backend sharded
    --mesh 4x1 --device cpu (a cap low enough that every merge after the
    first of a round is a giant, so the band path runs) writes the JAX
    package's --backend numpy -Rotated-Aligned.fasta byte for byte.  Bands
    of 64 rows keep the plain version's row loop short."""
    from csa_tpu import cli as jcli

    src = FIX / "tiny" / f"{name}-Rotated.fasta"
    for tag in ("jax", "port"):
        (tmp_path / tag).mkdir()
        (tmp_path / tag / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(progressive, "BATCH_DIRS_CAP", 1)
    monkeypatch.setattr(seqpar, "BAND_ROWS", 64)
    giants = _spy(monkeypatch, seqpar, "dp_path_seqpar")
    monkeypatch.chdir(tmp_path / "jax")
    assert jcli.main(["A", f"{name}-Rotated.fasta", "--backend",
                      "numpy"]) == 0
    monkeypatch.chdir(tmp_path / "port")
    assert cli.main(["A", f"{name}-Rotated.fasta", "--backend", "sharded",
                     "--mesh", "4x1", "--device", "cpu"]) == 0
    assert giants
    out = f"{name}-Rotated-Aligned.fasta"
    assert (tmp_path / "port" / out).read_bytes() == \
        (tmp_path / "jax" / out).read_bytes()


def test_cli_mesh_flag_parses_as_jax(capsys):
    from csa_tpu import cli as jcli

    assert cli._parse_mesh("4x2") == jcli._parse_mesh("4x2") == (4, 2)
    with pytest.raises(SystemExit):
        cli.main(["t1.txt", "--mesh", "4by2"])
    assert "SEQxPOS" in capsys.readouterr().err
