"""The band of the column-sharded profile DP in the profile DP's tiled
layout (csa_tpu_torch.dp.band), as far as the CPU can hold it: a numpy
twin of the tiled band fill against the plain version, the packing of
the direction bits against ``profile.dirs_address``, and the host walk
over the (rank, band) blocks of 1, 2 and 8 CPU ranks against the profile
DP's plain path and the JAX package's native host path.  The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).  Every comparison is exact."""

import numpy as np
import pytest
import torch

from csa_tpu import native as jnative
from csa_tpu_torch.dp import band, profile, seqpar
from csa_tpu_torch.parallel.sharded import make_mesh

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

DEFAULT = dict(match=1, mismatch=-1, indel=-1, doublegap=0)
NON_DEFAULT = dict(match=2, mismatch=-3, indel=-2, doublegap=-1)


@pytest.fixture
def small_tiles(monkeypatch):
    """Tiles of 128 x 32 cells (a strip of 4 rows a lane), so that small
    bands span several tiles."""
    monkeypatch.setattr(profile, "STRIP", 4)
    monkeypatch.setattr(profile, "TILE_COLS", 32)
    return profile.tile_rows(), profile.TILE_COLS


def _band_inputs(rng, Rb, Cloc, i, sc):
    """Seeded codes and score vector, a stale top row and a non-linear
    left column (a halo), as band_fill takes them."""
    sv = rng.integers(0, min(i, 64) + 1, size=(Cloc, 5))
    colsub, cg, rowgap = profile._channels(
        torch.from_numpy(sv)[None], torch.tensor([i]), **sc)
    return (torch.from_numpy(rng.integers(0, 4, size=Rb).astype(np.int8)),
            colsub[0].to(torch.int32), cg[0].to(torch.int32),
            int(rowgap[0]),
            torch.from_numpy(rng.integers(-400, 100, size=Cloc + 1)
                             .astype(np.int32)),
            torch.from_numpy(rng.integers(-400, 100, size=Rb)
                             .astype(np.int32)))


def _words_to_bytes(words: np.ndarray) -> torch.Tensor:
    """Direction words of 2 * STRIP bits -> the kernel's bytes."""
    return torch.from_numpy(
        words.astype(f"<u{profile.STRIP // 4}").view(np.uint8).copy())


def _band_twin(codes, colsub, cg, rowgap, top, left):
    """The band kernel's algorithm in numpy (the tile engine of
    csrc/tile_dp.cuh for one gap with an explicit left column and both
    outputs), tile by tile in ticket order: the shifted values W = dp -
    (j - j0) * rowgap - P, the boundary store of plain dp values, the left
    column at tile column 0 and in the corner of later tile rows, the two
    direction planes at dirs_address(), the bottom row from the last tile
    row and the right edge from the last tile column."""
    codes, colsub, cg = codes.numpy(), colsub.numpy(), cg.numpy()
    top, left = top.numpy().astype(np.int64), left.numpy().astype(np.int64)
    Rb, Cloc = len(codes), len(cg)
    meta, dirs_total, bnd_total, T = profile.batch_layout([Rb], [Cloc])
    assert meta[0, 4:10].tolist() == [0, 0, 0, 0, 0, 0]
    S, Tr, Tc = profile.STRIP, profile.tile_rows(), profile.TILE_COLS
    ntr, ntc = profile.tile_grid(Rb, Cloc)
    unset = np.iinfo(np.int64).min
    H = np.full((ntr, Cloc + 1), unset, dtype=np.int64)
    V = np.full((ntc, Rb + 1), unset, dtype=np.int64)
    assert bnd_total == H.size + V.size
    words = np.zeros(dirs_total * 4 // S, dtype=np.int64)
    bottom = np.full(Cloc + 1, unset, dtype=np.int64)
    edge = np.full(Rb, unset, dtype=np.int64)
    done = np.zeros((ntr, ntc), dtype=bool)
    for g, tr, tc in profile.tile_order([Rb], [Cloc]).tolist():
        assert g == 0
        assert tr == 0 or done[tr - 1, tc]
        assert tc == 0 or done[tr, tc - 1]
        j0, c0 = tr * Tr, tc * Tc
        h, w = min(Tr, Rb - j0), min(Tc, Cloc - c0)
        cgt = cg[c0: c0 + w].astype(np.int64)
        P = np.concatenate([[0], np.cumsum(cgt)])
        sub = colsub[c0: c0 + w].astype(np.int64) - rowgap - cgt[:, None]
        if tr == 0:
            topdp = top[c0: c0 + w + 1].copy()
        else:
            topdp = H[tr, c0: c0 + w + 1].copy()
            if c0 == 0:
                topdp[0] = left[j0 - 1]
        assert (topdp != unset).all()
        prev = topdp - P
        for r in range(h):
            j = j0 + 1 + r
            leftdp = left[j - 1] if tc == 0 else V[tc, j]
            assert leftdp != unset
            b = int(codes[j - 1])
            b = 4 if b < 0 or b > 4 else b
            cand = prev[:-1] + sub[:, b]
            cur = np.maximum.accumulate(np.concatenate(
                [[leftdp - (r + 1) * rowgap], np.maximum(cand, prev[1:])]))
            old, v = cur[:-1], cur[1:]
            left_wins = cand < old
            up_wins = np.maximum(cand, old) < prev[1:]
            word, bit = profile.dirs_address(Rb, Cloc, j,
                                             c0 + 1 + np.arange(w))
            words[word] |= (left_wins << bit) | (up_wins << (bit + S))
            if tc + 1 < ntc:
                V[tc + 1, j] = v[-1] + (r + 1) * rowgap + P[w]
            else:
                edge[j - 1] = v[-1] + (r + 1) * rowgap + P[w]
            prev = cur
        if tr + 1 < ntr:
            H[tr + 1, c0 + 1: c0 + w + 1] = prev[1:] + h * rowgap + P[1:]
        else:
            bottom[c0 + 1: c0 + w + 1] = prev[1:] + h * rowgap + P[1:]
            if tc == 0:
                bottom[0] = left[Rb - 1]
        done[tr, tc] = True
    assert done.all()
    assert (bottom != unset).all() and (edge != unset).all()
    return (_words_to_bytes(words), torch.from_numpy(bottom.astype(np.int32)),
            torch.from_numpy(edge.astype(np.int32)))


# (Rb, Cloc, i, scoring) on 128 x 32 tiles; every Cloc leaves a ragged
# last tile column but the first
TWIN_CASES = {
    "whole_tiles": (256, 96, 7, DEFAULT),
    "ragged_column": (256, 103, 7, DEFAULT),
    "ragged_row_off_strip": (293, 70, 5, DEFAULT),   # 293 = 2 x 128 + 37
    "ragged_row_on_strip": (168, 45, 5, DEFAULT),    # 40 rows, 10 strips
    "one_cell": (1, 1, 3, DEFAULT),
    "one_row": (1, 77, 3, DEFAULT),
    "one_column": (300, 1, 3, DEFAULT),
    "scoring_i64": (201, 90, 64, NON_DEFAULT),
}


@pytest.mark.parametrize("name", list(TWIN_CASES))
def test_band_twin_matches_plain(name, small_tiles):
    Rb, Cloc, i, sc = TWIN_CASES[name]
    args = _band_inputs(np.random.default_rng(len(name)), Rb, Cloc, i, sc)
    want = band.band_fill_plain(*args)
    got = _band_twin(*args)
    # both planes of every cell, and the bytes no cell owns stay 0
    assert torch.equal(band.cell_bits(got[0], Rb, Cloc),
                       band.cell_bits(want[0], Rb, Cloc))
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[2], want[2])
    # the carried row keeps the left boundary; the corner is shared
    assert int(want[1][0]) == int(args[5][-1])
    assert int(want[1][-1]) == int(want[2][-1])


# -- the layout --------------------------------------------------------------

@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("seed", range(3))
def test_pack_dirs_round_trips_at_dirs_address(tiles, seed, monkeypatch):
    """pack_dirs puts each cell's two bits where dirs_address says, and
    cell_bits / unpack_dirs read them back, at whole and ragged tiles."""
    if tiles == "small":
        monkeypatch.setattr(profile, "STRIP", 4)
        monkeypatch.setattr(profile, "TILE_COLS", 32)
    Tr, Tc = profile.tile_rows(), profile.TILE_COLS
    rng = np.random.default_rng(seed)
    S = profile.STRIP
    for Rb, Cloc in [(Tr, Tc), (Tr + 3, 2 * Tc - 1), (1, 1),
                     (int(rng.integers(1, 2 * Tr)),
                      int(rng.integers(1, 3 * Tc)))]:
        cells = torch.from_numpy(
            rng.integers(0, 4, size=(Rb, Cloc)).astype(np.int8))
        packed = band.pack_dirs(cells)
        assert packed.dtype == torch.uint8
        assert packed.numel() == band.dirs_bytes(Rb, Cloc)
        assert torch.equal(band.cell_bits(packed, Rb, Cloc), cells)
        assert torch.equal(band.unpack_dirs(packed, Rb, Cloc),
                           cells.clamp(max=profile.D_UP))
        codes = cells.clamp(max=profile.D_UP)
        assert torch.equal(band.unpack_dirs(band.pack_dirs(codes), Rb,
                                            Cloc), codes)
        words = packed.numpy().view(f"<u{S // 4}").astype(np.int64)
        j, c = np.meshgrid(np.arange(1, Rb + 1), np.arange(1, Cloc + 1),
                           indexing="ij")
        word, bit = profile.dirs_address(Rb, Cloc, j, c)
        got = ((words[word] >> bit) & 1) | (((words[word] >> (bit + S)) & 1)
                                            << 1)
        np.testing.assert_array_equal(got, cells.numpy())
        # no bit outside the cells is set
        mask = np.zeros_like(words)
        np.bitwise_or.at(mask, word, (1 << bit) | (1 << (bit + S)))
        assert not (words & ~mask).any()


# -- the walk over the (rank, band) blocks -----------------------------------

@pytest.mark.parametrize("n_ranks", [1, 2, 8])
def test_band_walk_plain_over_rank_blocks(n_ranks, small_tiles):
    """Bands of 150 rows (not a multiple of the 128-row tile), stale top,
    non-default scoring: the host walk over the filled blocks equals the
    profile DP's plain path and the JAX package's native host path."""
    rng = np.random.default_rng(50 + n_ranks)
    R, C, i = 401, 251, 6
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
    top = rng.integers(-300, 50, size=C + 1).astype(np.int64)
    erg = -9
    mesh = make_mesh(n_ranks, devices=[torch.device("cpu")])
    blocks, nb, Rb, Cloc = seqpar.fill_blocks(
        codes, sv, i, mesh, band_rows=150, top_row=top, edge_rowgap=erg,
        **NON_DEFAULT)
    assert (nb, Rb, Cloc) == (3, 150, -(-C // n_ranks))
    assert blocks.shape == (n_ranks * nb, band.dirs_bytes(Rb, Cloc))
    got = band.band_walk_plain(blocks, R, C, nb=nb, Rb=Rb, Cloc=Cloc)
    np.testing.assert_array_equal(
        got, band.band_walk(blocks, R, C, nb=nb, Rb=Rb, Cloc=Cloc))
    want = profile.profile_path(codes, sv, i, top, erg, device="cpu",
                                **NON_DEFAULT)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_ranks", [1, 2, 8])
def test_band_walk_plain_matches_native_host(n_ranks):
    """At the kernel's own tiles and the default scoring, against the JAX
    package's native host fill and walk."""
    rng = np.random.default_rng(70 + n_ranks)
    R, C, i = 333, 517, 9
    codes = rng.integers(0, 4, size=R).astype(np.int8)
    sv = rng.integers(0, i + 1, size=(C, 5)).astype(np.int64)
    top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
    erg = -11
    mesh = make_mesh(n_ranks, devices=[torch.device("cpu")])
    blocks, nb, Rb, Cloc = seqpar.fill_blocks(
        codes, sv, i, mesh, band_rows=100, top_row=top, edge_rowgap=erg,
        **DEFAULT)
    got = band.band_walk_plain(blocks, R, C, nb=nb, Rb=Rb, Cloc=Cloc)
    nat = jnative.dp_fill_path(codes, sv, i, top, erg)
    assert nat is not None
    np.testing.assert_array_equal(got, nat[1])
