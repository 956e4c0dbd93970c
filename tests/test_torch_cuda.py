"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``; each test skips where no CUDA device is present.
This file imports neither JAX nor the JAX package's device code, so the
card's machine runs it without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from csa_tpu_torch import kernels
from csa_tpu_torch.dp import band, nw, profile, seqpar
from csa_tpu_torch.index import engine, mscan
from csa_tpu_torch.parallel import (collect_sharded, distributed, dsort,
                                    dsort_ladder, teardown)
from csa_tpu_torch.parallel.sharded import make_mesh
from torch_mscan_inputs import KINDS, mscan_input


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _mscan_all_options(make):
    """Every option of both scans, one launch each, exact; ``make(is_min,
    reverse)`` gives the input of that scan."""
    for reverse in (False, True):
        for reduce in (False, True):
            before = kernels.COUNTS["mscan"]
            x = make(False, reverse)
            got = mscan.multi_cummax(x, reverse=reverse,
                                     min_over_channels=reduce)
            assert kernels.COUNTS["mscan"] == before + 1
            want = mscan.multi_cummax_plain(x, reverse=reverse,
                                            min_over_channels=reduce)
            torch.cuda.synchronize()
            assert torch.equal(got, want)
            x = make(True, reverse)
            got = mscan.multi_cummin(x, reverse=reverse,
                                     max_over_channels=reduce)
            assert kernels.COUNTS["mscan"] == before + 2
            want = mscan.multi_cummin_plain(x, reverse=reverse,
                                            max_over_channels=reduce)
            torch.cuda.synchronize()
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("M,N", [(1, 1), (3, 2047), (12, 70_001),
                                 (64, 4097), (12, 4095), (12, 8_003_584)])
def test_mscan_kernel_matches_plain(cuda, M, N, kind):
    """One tile and less, tile multiples +- 1 (the scalar path), and the
    8 x 1 Mbp rotation's 12 x 8,003,584 (the 16-byte path); on i.i.d.
    values, the collect cascade's channels and drifting walks, which set
    records in every tile (tests/torch_mscan_inputs.py)."""
    _mscan_all_options(lambda is_min, reverse: torch.from_numpy(mscan_input(
        kind, M, N, is_min=is_min, reverse=reverse, seed=M * 7 + N)
    ).to(cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_mscan_kernel_unaligned_rows(cuda, kind):
    """Rows whose start is not 16-byte aligned take the scalar path; the
    i.i.d. values hold the extremes of int32."""
    M, N = 5, 3 * mscan.TILE

    def make(is_min, reverse):
        flat = torch.empty(M * N + 1, dtype=torch.int32)
        if kind == "uniform":
            rng = np.random.default_rng(4)
            flat[:] = torch.from_numpy(rng.integers(
                -(2**31), 2**31, size=M * N + 1, dtype=np.int64
            ).astype(np.int32))
            flat[7] = -(2**31)
            flat[9000] = 2**31 - 1
        else:
            flat[1:] = torch.from_numpy(mscan_input(
                kind, M, N, is_min=is_min, reverse=reverse, seed=4).ravel())
        x = flat.to(cuda)[1:].view(M, N)
        assert x.data_ptr() % 16 != 0
        return x

    _mscan_all_options(make)


def _items(rng, G, rmax, cmax, i_max=17, stale=True):
    items = []
    for _ in range(G):
        R = int(rng.integers(1, rmax))
        C = int(rng.integers(1, cmax))
        i = int(rng.integers(1, i_max))
        codes = rng.integers(0, 4, size=R).astype(np.int64)
        sv = rng.integers(0, min(i, 64) + 1, size=(C, 5)).astype(np.int64)
        if stale:
            top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
            erg = int(rng.integers(-20, 0))
        else:
            top = profile.default_top_row(sv, i, indel=-1, doublegap=0)
            erg = -i
        items.append((codes, sv, i, top, erg))
    return items


def _shaped(rng, shapes, i=None, stale=True):
    """Items of the given (R, C) shapes; ``i`` fixed or drawn from 1..16."""
    items = []
    for R, C in shapes:
        n = i or int(rng.integers(1, 17))
        sv = rng.integers(0, min(n, 64) + 1, size=(C, 5)).astype(np.int64)
        if stale:
            top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
            erg = int(rng.integers(-20, 0))
        else:
            top = profile.default_top_row(sv, n, indel=-1, doublegap=0)
            erg = -n
        items.append((rng.integers(0, 4, size=R).astype(np.int64), sv, n,
                      top, erg))
    return items


PROFILE_CASES = ["ragged_stale", "fresh", "i64", "thin", "tile_edges",
                 "below_one_tile", "giant_among_tiny", "stale_scoring_i64",
                 "wide_30000"]


def _profile_case(case, rng):
    Tr, Tc = profile.tile_rows(), profile.TILE_COLS
    sc = {}
    if case == "ragged_stale":
        items = _items(rng, 12, 700, 900)
    elif case == "fresh":
        items = _items(rng, 5, 300, 300, stale=False)
        sc = dict(match=3, mismatch=-2, indel=-4, doublegap=-1)
    elif case == "i64":
        items = _items(rng, 3, 200, 200, i_max=65)
        items = [(c, s, 64, t, e) for c, s, _, t, e in items]
    elif case == "thin":
        items = _shaped(rng, [(1, 500), (500, 1), (1, 1)], i=3, stale=False)
    elif case == "tile_edges":  # tile multiples and one cell either side
        items = _shaped(rng, [(Tr, Tc), (Tr + 1, Tc + 1), (Tr - 1, Tc - 1),
                              (2 * Tr, 3 * Tc), (2 * Tr + 1, 3 * Tc - 1),
                              (2 * Tr - 1, 3 * Tc + 1)])
    elif case == "below_one_tile":
        items = _shaped(rng, [(Tr // 7, Tc // 3)])
    elif case == "giant_among_tiny":  # the queue interleaves the gaps
        items = (_items(rng, 20, 20, 20) + _shaped(rng, [(3000, 4500)])
                 + _items(rng, 20, 20, 20))
    elif case == "stale_scoring_i64":
        items = _shaped(rng, [(700, 1300), (1300, 700)], i=64)
        sc = dict(match=2, mismatch=-3, indel=-2, doublegap=-1)
    else:  # far wider than one block's shared memory could hold in rows
        items = _shaped(rng, [(300, 30_000), (50, 2)])
    return items, sc


@pytest.mark.cuda
@pytest.mark.parametrize("case", PROFILE_CASES)
def test_profile_kernel_matches_plain(cuda, case):
    items, sc = _profile_case(case, np.random.default_rng(len(case)))
    before = kernels.COUNTS["profile_dp"]
    got = profile.profile_paths(items, cuda, **sc)
    assert kernels.COUNTS["profile_dp"] == before + 1
    want = profile.profile_paths_plain(items, cuda, **sc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("strip,tile_cols", [(16, 256), (8, 512), (16, 64)])
def test_profile_kernel_other_tiles(cuda, monkeypatch, strip, tile_cols):
    """The kernel's other strip width and other tile widths."""
    monkeypatch.setattr(profile, "STRIP", strip)
    monkeypatch.setattr(profile, "TILE_COLS", tile_cols)
    items, sc = _profile_case("tile_edges", np.random.default_rng(strip))
    items += _profile_case("ragged_stale", np.random.default_rng(1))[0]
    got = profile.profile_paths(items, cuda, **sc)
    want = profile.profile_paths_plain(items, cuda, **sc)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_profile_two_launches_on_two_streams(cuda):
    """profile_paths_sharded on two ranks of one card: two launches at
    once, each with its own counter and flags, each exact."""
    rng = np.random.default_rng(2)
    items = _shaped(rng, [(2048, 2048)] * 6) + _items(rng, 6, 900, 900)
    mesh = make_mesh(2, devices=[cuda])
    before = kernels.COUNTS["profile_dp"]
    got = profile.profile_paths_sharded(items, mesh)
    assert kernels.COUNTS["profile_dp"] == before + 2
    want = profile.profile_paths_plain(items, cuda)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("B,la,lb", [(3, 40, 55), (2, 1, 7), (2, 7, 1),
                                     (4, 131, 62), (1, 1000, 999),
                                     (2, 5000, 301), (2, 12_001, 77),
                                     (2, 20_481, 50), (1, 45_000, 9)])
def test_nw_kernel_matches_plain(cuda, B, la, lb):
    """One to 88 row bands, band heights that do not divide la, ragged
    and edge shapes; exact against the plain version."""
    rng = np.random.default_rng(B * la + lb)
    a = torch.from_numpy(rng.integers(0, 4, size=(B, la))).to(cuda)
    b = torch.from_numpy(rng.integers(0, 4, size=(B, lb))).to(cuda)
    before = kernels.COUNTS["nw"]
    got = nw.pairwise_nw_scores(a, b, cuda)
    assert kernels.COUNTS["nw"] == before + 1
    want = nw.pairwise_nw_scores_plain(a.to(torch.int32), b.to(torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if la * lb <= 1_000_000:
        host = nw.nw_scores_host(a.cpu().numpy(), b.cpu().numpy())
        np.testing.assert_array_equal(got.cpu().numpy(), host)


@pytest.mark.cuda
@pytest.mark.parametrize("B,la,lb", [(4500, 600, 50), (1, 45_000, 3000)])
def test_nw_kernel_queue_shapes(cuda, B, la, lb):
    """More tickets than the card holds workers at once (4,500 pairs of
    two bands), and one pair of 88 bands with chunks handed down a long
    chain; exact against the plain version."""
    rng = np.random.default_rng(B + la)
    a = torch.from_numpy(rng.integers(0, 4, size=(B, la))).to(cuda)
    b = torch.from_numpy(rng.integers(0, 4, size=(B, lb))).to(cuda)
    got = nw.pairwise_nw_scores(a, b, cuda)
    want = nw.pairwise_nw_scores_plain(a.to(torch.int32), b.to(torch.int32))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_nw_two_launches_on_two_streams(cuda):
    """Two NW batches at once on two streams, each with its own tickets
    and carry rows, each exact."""
    rng = np.random.default_rng(12)
    shapes = [(40, 3000, 2500), (7, 5000, 700)]
    pairs = [(torch.from_numpy(rng.integers(0, 4, size=(B, la))).to(cuda),
              torch.from_numpy(rng.integers(0, 4, size=(B, lb))).to(cuda))
             for B, la, lb in shapes]
    streams = [torch.cuda.Stream(cuda) for _ in shapes]
    got = []
    for (a, b), st in zip(pairs, streams):
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            got.append(nw.pairwise_nw_scores(a, b, cuda))
    torch.cuda.synchronize()
    for (a, b), g in zip(pairs, got):
        assert torch.equal(g, nw.pairwise_nw_scores_plain(
            a.to(torch.int32), b.to(torch.int32)))


def _band_args(rng, Rb, Cloc, i, rank0, dev):
    """One band's inputs: seeded codes and score vector, a stale top row,
    and a rank-0 edge (j * edge_rowgap) or random halo as left column."""
    sv = rng.integers(0, min(i, 64) + 1, size=(Cloc, 5))
    colsub, cg, rowgap = profile._channels(
        torch.from_numpy(sv)[None], torch.tensor([i]), match=1, mismatch=-1,
        indel=-1, doublegap=0)
    left = (-i * np.arange(1, Rb + 1) if rank0
            else rng.integers(-400, 100, size=Rb))
    put = lambda a, dt: torch.as_tensor(a, dtype=dt).to(dev)  # noqa: E731
    return (put(rng.integers(0, 4, size=Rb), torch.int8),
            put(colsub[0], torch.int32), put(cg[0], torch.int32),
            int(rowgap[0]), put(rng.integers(-400, 100, size=Cloc + 1),
                                torch.int32), put(left, torch.int32))


def _band_equal(got, want, Rb, Cloc):
    """Both direction bits of every cell, the bottom row and the edge
    (the bytes of a ragged tile that hold no cell are undefined)."""
    assert torch.equal(band.cell_bits(got[0], Rb, Cloc),
                       band.cell_bits(want[0], Rb, Cloc))
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("Rb,Cloc,i,rank0", [
    (37, 301, 5, True),          # rank 0's edge band, Rb not a multiple of 4
    (256, 129, 64, False),       # a halo band, i = 64
    (16, 30_000, 9, False),      # one tile row, 118 tile columns
    (777, 1_001, 7, False),      # Rb and Cloc not multiples of 256
    (2048, 30_000, 9, False),    # once global scratch (3 x 30,001 int32)
])
def test_band_kernel_matches_plain(cuda, Rb, Cloc, i, rank0):
    """Twice on one scratch: each launch zeroes its ticket counter and
    flags first."""
    rng = np.random.default_rng(Rb + Cloc)
    args = _band_args(rng, Rb, Cloc, i, rank0, cuda)
    scratch = band.scratch_for(Rb, Cloc, args[3], cuda)
    want = band.band_fill_plain(*args)
    for _ in range(2):
        before = kernels.COUNTS["band"]
        got = band.band_fill(*args, scratch=scratch)
        assert kernels.COUNTS["band"] == before + 1
        torch.cuda.synchronize()
        _band_equal(got, want, Rb, Cloc)


@pytest.mark.cuda
def test_band_two_launches_on_two_streams(cuda):
    """Two bands at once on two streams of the one card (the sharded
    path's shape), each with its own scratch, each exact."""
    rng = np.random.default_rng(8)
    shapes = [(2048, 2607, 9, False), (1000, 1500, 5, True)]
    args = [_band_args(rng, *shape, cuda) for shape in shapes]
    scratch = [band.scratch_for(Rb, Cloc, a[3], cuda)
               for (Rb, Cloc, _, _), a in zip(shapes, args)]
    streams = [torch.cuda.Stream(cuda) for _ in shapes]
    got = []
    for a, sc, st in zip(args, scratch, streams):
        st.wait_stream(torch.cuda.current_stream(cuda))
        with torch.cuda.stream(st):
            got.append(band.band_fill(*a, scratch=sc))
    torch.cuda.synchronize()
    for (Rb, Cloc, _, _), a, g in zip(shapes, args, got):
        _band_equal(g, band.band_fill_plain(*a), Rb, Cloc)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ranks", [2, 4])
def test_dp_path_seqpar_matches_profile_kernel(cuda, n_ranks):
    """Ranks sharing the one card, a stale top row: the band path equals
    the single-device profile kernel's."""
    rng = np.random.default_rng(n_ranks)
    R, C, i = 700, 901, 7
    codes = rng.integers(0, 4, size=R)
    sv = rng.integers(0, i + 1, size=(C, 5))
    top = rng.integers(-60, 10, size=C + 1)
    mesh = make_mesh(n_ranks, devices=[cuda])
    before = kernels.COUNTS["band"]
    got = seqpar.dp_path_seqpar(codes, sv, i, mesh, band_rows=128,
                                top_row=top, edge_rowgap=-5)
    # 6 bands on each rank, then one walk
    assert kernels.COUNTS["band"] == before + 6 * n_ranks + 1
    want = profile.profile_path(codes, sv, i, top, -5, device=cuda)
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_ranks", [2, 4, 8])
@pytest.mark.parametrize("keys", ["tied", "unique"])
def test_sharded_argsort_on_one_card(cuda, n_ranks, keys):
    """Ranks sharing the one card, a stream each: the merge-split network
    gives the stable order, on keys with heavy ties and on unique ones."""
    gen = torch.Generator(device=cuda).manual_seed(n_ranks)
    n = 1 << 21
    v = (torch.randint(0, 7, (n,), device=cuda, generator=gen)
         if keys == "tied" else
         torch.randperm(n, device=cuda, generator=gen) - n // 2)
    v = v.to(torch.int32)
    want_v, want_o = torch.sort(v, stable=True)
    vals, order = dsort.sharded_argsort(v, make_mesh(n_ranks, devices=[cuda]))
    torch.cuda.synchronize()
    assert torch.equal(vals, want_v)
    assert torch.equal(order, want_o)


def _circular_set(k, n, seed, noise=200):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    enc = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=max(1, n // noise))
        row[idx] = rng.integers(0, 4, size=len(idx))
        enc.append(row)
    return enc


@pytest.mark.cuda
def test_ladder_and_front_on_a_four_rank_card_mesh(cuda):
    """The sharded build and front on 4 ranks of the one card equal the
    single-device ones, twice in a row (a buffer that the allocator
    handed out again while a rank still read it would show as a
    difference); each rank's front launches its three scans."""
    enc = _circular_set(8, 200_000, seed=5)
    (wo, wl, wn), waux = engine._device_build(enc, cuda)
    k, n_max, mg0 = waux
    kw = dict(k=k, n_max=n_max, tdeep=engine._tdeep_for(mg0, k, n_max),
              pack_w=12)
    want = engine._collect_front(wo, wl, wn, **kw)
    mesh = make_mesh(4, devices=[cuda])
    for _ in range(2):
        (o, lcp, n_of), aux = dsort_ladder.device_build_dsort(enc, mesh)
        before = kernels.COUNTS["mscan"]
        got = collect_sharded.collect_front(mesh, o, lcp, n_of, **kw)
        assert kernels.COUNTS["mscan"] == before + 3 * 4
        torch.cuda.synchronize()
        assert aux == waux
        assert torch.equal(o, wo) and torch.equal(lcp, wl)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
def test_multiprocess_dryrun_on_one_card_over_gloo(cuda):
    """2 processes x 2 ranks sharing the one card: the world takes gloo
    (NCCL refuses two processes on one device), and the ladder, the
    final blocks and the rank-split gap DP (the kernels, each process on
    its own ranks) equal one process's."""
    res = distributed.run_multiprocess_dryrun(2, 2, "cuda", timeout=600)
    assert res.get("ok"), res
    assert res["backend"] == "gloo" and res["device"].startswith("cuda")
    assert res["rank_process_bytes"] > 0


@pytest.mark.cuda
def test_multiprocess_dryrun_over_nccl_a_card_a_process(cuda):
    """2 processes, each seeing a card of its own: the world takes NCCL."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: NCCL takes a card of its own a process")
    res = distributed.run_multiprocess_dryrun(2, 2, "cuda", timeout=600,
                                              visible=["0", "1"])
    assert res.get("ok"), res
    assert res["backend"] == "nccl"


@pytest.mark.cuda
def test_teardown_worlds_on_one_card_over_gloo(cuda):
    """Four two-process worlds sharing card 0 (gloo), two to a pair of
    processes: every Ranks exchange on CUDA ranks equals one process's,
    each shutdown() frees its group, and every process exits 0."""
    res = teardown.run_teardown_loop(4, device="cuda", worlds_per_process=2,
                                     timeout=600, visible=["0", "0"])
    assert (res["aborts"], res["failed"]) == (0, 0), res
    assert all(r["backend"] == "gloo" and r["group_freed"]
               for r in res["records"])


@pytest.mark.cuda
def test_teardown_worlds_over_nccl_a_card_a_process(cuda):
    """The same over NCCL, a card a process: the NCCL group goes before
    the gloo world it rides on."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 cards: NCCL takes a card of its own a process")
    res = teardown.run_teardown_loop(4, device="cuda", worlds_per_process=2,
                                     timeout=600, visible=["0", "1"])
    assert (res["aborts"], res["failed"]) == (0, 0), res
    assert all(r["backend"] == "nccl" and r["group_freed"]
               for r in res["records"])


@pytest.mark.cuda
def test_set3_merge_gate_above_every_merge_matches_default(cuda, tmp_path,
                                                           monkeypatch):
    """Set3 with ``--device-min-cells`` above its largest merge (every
    merge that goes alone takes the native host fill) against the
    default gates: the same rotated and aligned files, byte for byte."""
    import pathlib

    from csa_tpu_torch import cli, config

    fix = pathlib.Path(__file__).resolve().parent / "fixtures"
    out = {}
    try:
        for tag, extra in (("default", []),
                           ("above", ["--device-min-cells", str(1 << 62)])):
            d = tmp_path / tag
            d.mkdir()
            (d / "Set3.txt").write_bytes((fix / "Set3.txt").read_bytes())
            monkeypatch.chdir(d)
            assert cli.main(["Set3.txt", *extra]) == 0
            out[tag] = [(d / f"Set3{s}").read_bytes()
                        for s in ("-Rotated.fasta", "-Aligned.fasta")]
    finally:
        config.set_run_config(config.RunConfig())
    assert out["above"] == out["default"]
    assert out["default"][0] == (fix / "Set3-Rotated.fasta").read_bytes()


def _fixture_encoded(name):
    import io
    import pathlib

    from csa_tpu_torch.io import fasta as tfio

    fix = pathlib.Path(__file__).resolve().parent / "fixtures"
    seqs = tfio.load_fasta(str(fix / f"{name}.txt"), log=io.StringIO())
    return seqs.encoded_all()


def _same_final(got, want):
    assert (got.num_collected, got.num_after_suffix) == \
        (want.num_collected, want.num_after_suffix)
    for f in ("final_start", "final_depth", "final_positions"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Primates", "Set3"])
def test_fused_block_stage_replay_matches_staged(cuda, name):
    """The fused block stage as a CUDA graph replay equals the eager
    staged stage; a second call with the same key replays the cached
    graph without capturing again, and each replay launches mscan three
    times."""
    from csa_tpu_torch.index import graphs

    enc = _fixture_encoded(name)
    want = engine.rotation_final_staged(enc, cuda)
    _same_final(engine._rotation_final_fused(enc, cuda), want)
    captures, replays = graphs.STATS["captures"], graphs.STATS["replays"]
    kernels.reset_counts()
    _same_final(engine._rotation_final_fused(enc, cuda), want)
    assert graphs.STATS["captures"] == captures
    assert graphs.STATS["replays"] == replays + 1
    assert kernels.COUNTS["mscan"] == 3


def _forget_keys(monkeypatch):
    """Empty block-stage guess caches and no captured graph: every key
    is one this process has not run."""
    from csa_tpu_torch.index import graphs

    for cache in ("_TDEEP_CACHE", "_CAPS_CACHE", "_LEVELS_CACHE"):
        monkeypatch.setattr(engine, cache, {})
    graphs.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["Primates", "Set3"])
def test_rotation_final_replays_from_its_second_call(cuda, name,
                                                     monkeypatch):
    """Three rotation_final calls of one key: the first is staged (no
    capture; two reads at level 0, one a refinement level, seven in the
    tail: 14 on Primates), the second captures the fused program once
    (the guesses the first recorded pass every check: one download),
    the third replays it (no capture, one device read, mscan's three
    launches); each equals the staged stage."""
    from csa_tpu_torch.index import graphs
    from csa_tpu_torch.utils import PROFILER

    enc = _fixture_encoded(name)
    want = engine.rotation_final_staged(enc, cuda)
    _forget_keys(monkeypatch)
    seen = []
    PROFILER.enabled = True
    try:
        for _ in range(3):
            PROFILER.reset()
            captures = graphs.STATS["captures"]
            kernels.reset_counts()
            got = engine.rotation_final(enc, cuda)
            c = PROFILER.counters
            seen.append((graphs.STATS["captures"] - captures,
                         c.get("graph_captures", 0),
                         c.get("graph_replays", 0),
                         c.get("idx.device_reads", 0),
                         kernels.COUNTS["mscan"]))
            _same_final(got, want)
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    key = (len(enc), engine._bucket(max(len(e) for e in enc)))
    assert seen[0] == (0, 0, 0, 9 + engine._LEVELS_CACHE[key], 3)
    if name == "Primates":
        assert seen[0][3] == 14
    assert seen[1][:4] == (1, 1, 1, 1)
    assert seen[2] == (0, 0, 1, 1, 3)


@pytest.mark.cuda
def test_two_warm_cli_jobs_write_the_fixture(cuda, tmp_path, monkeypatch):
    """Two mode R jobs on Primates through cli.main in one process: the
    first runs the block stage staged, the second the fused program;
    both write the fixture's rotated file byte for byte."""
    import pathlib

    from csa_tpu_torch import cli, config
    from csa_tpu_torch.index import graphs

    _forget_keys(monkeypatch)
    fix = pathlib.Path(__file__).resolve().parent / "fixtures"
    replays = []
    try:
        for i in range(2):
            d = tmp_path / f"job{i}"
            d.mkdir()
            (d / "Primates.txt").write_bytes(
                (fix / "Primates.txt").read_bytes())
            monkeypatch.chdir(d)
            before = graphs.STATS["replays"]
            assert cli.main(["R", "Primates.txt"]) == 0
            replays.append(graphs.STATS["replays"] - before)
            assert (d / "Primates-Rotated.fasta").read_bytes() == \
                (fix / "Primates-Rotated.fasta").read_bytes()
    finally:
        config.set_run_config(config.RunConfig())
    assert replays == [0, 1]


@pytest.mark.cuda
def test_a_fresh_cli_child_captures_nothing(cuda, tmp_path):
    """A ``python -m csa_tpu_torch.cli R`` process calls the block stage
    once: staged, with no capture and no replay, 14 device reads on
    Primates, and the fixture's rotated file."""
    import os
    import pathlib
    import subprocess
    import sys

    root = pathlib.Path(__file__).resolve().parent.parent
    fix = root / "tests" / "fixtures"
    (tmp_path / "Primates.txt").write_bytes(
        (fix / "Primates.txt").read_bytes())
    proc = subprocess.run(
        [sys.executable, "-m", "csa_tpu_torch.cli", "R", "Primates.txt",
         "--profile"], cwd=tmp_path, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(root)}, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = proc.stdout + proc.stderr
    assert "> [profile] idx.device_reads: 14\n" in out
    assert "graph_captures" not in out and "graph_replays" not in out
    assert (tmp_path / "Primates-Rotated.fasta").read_bytes() == \
        (fix / "Primates-Rotated.fasta").read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1])
def test_fused_linear_sort_replay_matches_staged(cuda, seed, monkeypatch):
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(4):
        parts += [rng.integers(0, 4, size=int(rng.integers(20_000, 40_000)))
                  + 4, [i]]
    s = np.concatenate(parts).astype(np.int64)
    monkeypatch.setattr(engine, "FUSED_MAX_CHARS", 1 << 62)
    got = [engine.linear_suffix_order(s, cuda) for _ in range(2)]
    monkeypatch.setattr(engine, "FUSED_MAX_CHARS", 0)
    want = engine.linear_suffix_order(s, cuda)
    for sa, lcp in got:
        np.testing.assert_array_equal(sa, want[0])
        np.testing.assert_array_equal(lcp, want[1])


@pytest.mark.cuda
def test_failing_capture_raises(cuda):
    """A program that reads the host while it is being captured raises
    (no eager fallback) and leaves no graph behind; the fused route
    still replays afterwards."""
    from csa_tpu_torch.index import graphs

    calls = []

    def program(x):
        calls.append(1)
        if len(calls) == 2:   # the capture, after an eager warm-up
            x.sum().item()
        return x * 2

    key = ("host-read-in-capture",)
    with pytest.raises(RuntimeError):
        graphs.run(key, program, (torch.ones(8, dtype=torch.int64),), cuda)
    assert not any(k[1] == key for k in graphs._CACHE)
    enc = _fixture_encoded("Primates")
    _same_final(engine._rotation_final_fused(enc, cuda),
                engine.rotation_final_staged(enc, cuda))
