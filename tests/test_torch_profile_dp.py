"""Port profile DP (csa_tpu_torch.dp.profile) against the JAX package's
Pallas profile kernel run in interpret mode, over the cases of
tests/test_pallas_profile.py: ragged batches with stale boundaries, fresh
default boundaries, i = 64, degenerate R = 1 / C = 1 shapes, the
511/512/513 edges and non-default scoring.  Paths are integer codes, so
every comparison is exact.  Each scoring is one batched Pallas call (one
interpret-mode compile), shared by the cases through a module fixture.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from csa_tpu import config
from csa_tpu import native as jnative
from csa_tpu.align import progressive
from csa_tpu.dp import pallas_profile
from csa_tpu_torch import kernels
from csa_tpu_torch.dp import profile

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

NON_DEFAULT = config.Scoring(match=3, mismatch=-2, indel=-4, doublegap=-1)


def _stale(rng, rmax=120, cmax=160):
    R = int(rng.integers(1, rmax))
    C = int(rng.integers(1, cmax))
    i = int(rng.integers(1, 17))
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = rng.integers(0, 4, size=(C, 5)).astype(np.int64)
    # stale-allocation boundaries: arbitrary top row / edge scale
    top = rng.integers(-60, 10, size=C + 1).astype(np.int64)
    top[0] = 0
    return codes, sv, i, top, int(rng.integers(-20, 0))


def _fresh(rng, R, C, i, hi, sc=config.DEFAULT_SCORING):
    codes = rng.integers(0, 4, size=R).astype(np.int64)
    sv = rng.integers(0, hi, size=(C, 5)).astype(np.int64)
    top = profile.default_top_row(sv, i, indel=sc.indel,
                                  doublegap=sc.doublegap)
    return codes, sv, i, top, sc.indel * i


def _default_cases():
    rng = np.random.default_rng(7)
    cases = {f"stale{n}": _stale(rng) for n in range(4)}
    cases["fresh_64x200"] = _fresh(rng, 64, 200, 9, 5)
    cases["i64"] = _fresh(rng, 90, 140, 64, 65)
    for R, C in [(1, 40), (40, 1), (1, 1), (512, 512), (513, 511),
                 (511, 513)]:
        cases[f"shape_{R}x{C}"] = _fresh(rng, R, C, 5, 3)
    return cases


def _non_default_cases():
    rng = np.random.default_rng(3)
    cases = {f"stale{n}": _stale(rng) for n in range(3)}
    cases["i64"] = _fresh(rng, 90, 140, 64, 65, NON_DEFAULT)
    cases["shape_1x40"] = _fresh(rng, 1, 40, 3, 3, NON_DEFAULT)
    return cases


DEFAULT_CASES = _default_cases()
NON_DEFAULT_CASES = _non_default_cases()


@pytest.fixture(scope="module")
def pallas_default():
    names = list(DEFAULT_CASES)
    paths = pallas_profile.profile_paths_pallas(
        [DEFAULT_CASES[n] for n in names], interpret=True)
    return dict(zip(names, paths))


@pytest.fixture(scope="module")
def pallas_non_default():
    names = list(NON_DEFAULT_CASES)
    config.set_scoring(NON_DEFAULT)
    try:
        paths = pallas_profile.profile_paths_pallas(
            [NON_DEFAULT_CASES[n] for n in names], interpret=True)
    finally:
        config.set_scoring(config.DEFAULT_SCORING)
    return dict(zip(names, paths))


@pytest.fixture(scope="module")
def plain_default():
    names = list(DEFAULT_CASES)
    paths = profile.profile_paths([DEFAULT_CASES[n] for n in names], "cpu")
    return dict(zip(names, paths))


@pytest.mark.parametrize("name", list(DEFAULT_CASES))
def test_batched_plain_matches_pallas(name, pallas_default, plain_default):
    np.testing.assert_array_equal(plain_default[name], pallas_default[name])


@pytest.mark.parametrize("name", ["stale0", "fresh_64x200", "i64",
                                  "shape_40x1", "shape_513x511"])
def test_single_gap_plain_matches_pallas(name, pallas_default):
    got = profile.profile_path(*DEFAULT_CASES[name], device="cpu")
    np.testing.assert_array_equal(got, pallas_default[name])


def test_single_gap_default_boundaries():
    codes, sv, i, top, erg = DEFAULT_CASES["fresh_64x200"]
    a = profile.profile_path(codes, sv, i, device="cpu")
    b = profile.profile_path(codes, sv, i, top, erg, device="cpu")
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(NON_DEFAULT_CASES))
def test_non_default_scoring_plain_matches_pallas(name, pallas_non_default):
    got = profile.profile_paths(
        [NON_DEFAULT_CASES[name]], "cpu", match=NON_DEFAULT.match,
        mismatch=NON_DEFAULT.mismatch, indel=NON_DEFAULT.indel,
        doublegap=NON_DEFAULT.doublegap)[0]
    np.testing.assert_array_equal(got, pallas_non_default[name])


def test_paths_match_host_golden_maps():
    """The walk-order codes feed csa_tpu's _path_to_maps unchanged."""
    item = DEFAULT_CASES["stale1"]
    codes, sv, i, top, erg = item
    _, dirs = progressive.dp_fill(codes, sv, i, top_row=top, edge_rowgap=erg)
    want = progressive._dirs_to_maps(dirs, len(codes), len(sv))
    got = progressive._path_to_maps(profile.profile_paths([item], "cpu")[0])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cpu_takes_plain_version_without_launch():
    kernels.reset_counts()
    profile.profile_paths([DEFAULT_CASES["stale2"]], "cpu")
    assert kernels.COUNTS["profile_dp"] == 0


def test_wrapper_raises_for_other_devices():
    with pytest.raises(ValueError, match="no kernel"):
        profile.profile_paths([DEFAULT_CASES["stale2"]], "meta")


# --- the tiled layout of the CUDA kernel, as far as the CPU can hold it ---

@pytest.fixture
def small_tiles(monkeypatch):
    """Tiles of 128 x 32 cells (a strip of 4 rows a lane), so that small
    gaps span several tiles."""
    monkeypatch.setattr(profile, "STRIP", 4)
    monkeypatch.setattr(profile, "TILE_COLS", 32)
    return profile.tile_rows(), profile.TILE_COLS


@pytest.mark.parametrize("tiles", ["kernel", "small"])
@pytest.mark.parametrize("seed", range(3))
def test_dirs_bytes_is_what_the_layout_addresses(tiles, seed, monkeypatch):
    """Every cell of a gap owns a bit of its own in each plane of a word
    inside dirs_bytes(), and a gap of whole tiles uses every bit of it."""
    if tiles == "small":
        monkeypatch.setattr(profile, "STRIP", 4)
        monkeypatch.setattr(profile, "TILE_COLS", 32)
    Tr, Tc = profile.tile_rows(), profile.TILE_COLS
    rng = np.random.default_rng(seed)
    shapes = [(Tr, Tc), (Tr + 1, Tc - 1), (Tr - 1, Tc + 1), (2 * Tr, 3 * Tc),
              (1, 2 * Tc + 1), (Tr + 1, 1),
              (int(rng.integers(1, 3 * Tr)), int(rng.integers(1, 4 * Tc)))]
    for R, C in shapes:
        ntr, ntc = profile.tile_grid(R, C)
        assert profile.dirs_bytes(R, C) == ntr * ntc * Tr * Tc // 4
        j, c = np.meshgrid(np.arange(1, R + 1), np.arange(1, C + 1),
                           indexing="ij")
        word, bit = profile.dirs_address(R, C, j, c)
        words = profile.dirs_bytes(R, C) * 4 // profile.STRIP
        assert word.min() >= 0 and word.max() < words
        assert bit.min() >= 0 and bit.max() < profile.STRIP
        slots = np.unique(word * profile.STRIP + bit)
        assert slots.size == R * C
        if R % Tr == 0 and C % Tc == 0:
            assert slots.size == 4 * profile.dirs_bytes(R, C)


def _ragged_shapes(rng, G, rmax, cmax):
    return (rng.integers(1, rmax, size=G), rng.integers(1, cmax, size=G))


@pytest.mark.parametrize("G", [1, 2, 7, 23, 50])
def test_tile_order_puts_predecessors_first(G, small_tiles):
    """Every tile's upper and left neighbours hold lower tickets, and the
    tiles of a ragged batch cover every cell of every gap once."""
    Tr, Tc = small_tiles
    rng = np.random.default_rng(G)
    rr, cc = _ragged_shapes(rng, G, 5 * Tr, 9 * Tc)
    if G > 2:
        rr[0], cc[0] = 2 * Tr, 3 * Tc          # whole tiles
        rr[1], cc[1] = 2 * Tr + 1, 3 * Tc + 1  # one cell more each way
    order = profile.tile_order(rr, cc)
    meta, dirs_total, bnd_total, T = profile.batch_layout(rr, cc)
    assert order.shape == (T, 3) and order.dtype == np.int32
    ticket = {tuple(row): n for n, row in enumerate(order.tolist())}
    assert len(ticket) == T
    cells = np.zeros(G, dtype=np.int64)
    for (g, tr, tc), n in ticket.items():
        if tr:
            assert ticket[(g, tr - 1, tc)] < n
        if tc:
            assert ticket[(g, tr, tc - 1)] < n
        h = min(Tr, rr[g] - tr * Tr)
        w = min(Tc, cc[g] - tc * Tc)
        assert h > 0 and w > 0
        cells[g] += h * w
    np.testing.assert_array_equal(cells, rr * cc)
    # the table's segments are disjoint and add up to the totals
    assert dirs_total == sum(profile.dirs_bytes(int(r), int(c))
                             for r, c in zip(rr, cc))
    np.testing.assert_array_equal(meta[:, 9], np.concatenate(
        [[0], np.cumsum([np.prod(profile.tile_grid(int(r), int(c)))
                         for r, c in zip(rr, cc)])[:-1]]))
    assert bnd_total >= meta[-1, 8]


def _tiled_twin(items, **sc):
    """The kernel's algorithm in numpy, tile by tile in ticket order: the
    shifted values W = dp - (j - j0) * rowgap - P, the boundary store of
    plain dp values, the two direction planes at dirs_address() and the
    walk over them.  Holds the layout, the shift and the hand-off between
    tiles against the plain version; the CUDA source follows it line by
    line."""
    rr = np.array([len(it[0]) for it in items])
    cc = np.array([len(it[1]) for it in items])
    iv = np.array([it[2] for it in items])
    meta, dirs_total, bnd_total, T = profile.batch_layout(rr, cc)
    meta[:, 2] = sc["indel"] * iv
    meta[:, 3] = [it[4] for it in items]
    codes = np.concatenate([np.asarray(it[0]) for it in items])
    sv = np.concatenate([np.asarray(it[1]).reshape(-1, 5) for it in items])
    top = np.concatenate([np.asarray(it[3])[: C + 1]
                          for it, C in zip(items, cc)])
    colsub, cg, _ = profile._channels(
        torch.from_numpy(sv)[:, None, :], torch.from_numpy(np.repeat(iv, cc)),
        **sc)
    colsub, cg = colsub.numpy().reshape(-1, 5), cg.numpy().reshape(-1)
    unset = np.iinfo(np.int64).min
    bnd = np.full(bnd_total, unset, dtype=np.int64)
    S = profile.STRIP
    dirs = np.zeros(dirs_total * 4 // S, dtype=np.uint32)  # words
    word_off = meta[:, 7] * 4 // S
    flags = np.zeros(T, dtype=bool)
    Tr, Tc = profile.tile_rows(), profile.TILE_COLS
    for g, tr, tc in profile.tile_order(rr, cc).tolist():
        (R, C, rg, eg, code_off, col_off, top_off, dirs_off, bnd_off,
         flag_off) = meta[g].tolist()
        ntr, ntc = profile.tile_grid(R, C)
        tile = tr * ntc + tc
        assert tr == 0 or flags[flag_off + tile - ntc]
        assert tc == 0 or flags[flag_off + tile - 1]
        j0, c0 = tr * Tr, tc * Tc
        h, w = min(Tr, R - j0), min(Tc, C - c0)
        H = bnd[bnd_off: bnd_off + ntr * (C + 1)].reshape(ntr, C + 1)
        V = bnd[bnd_off + ntr * (C + 1):
                bnd_off + ntr * (C + 1) + ntc * (R + 1)].reshape(ntc, R + 1)
        cgt = cg[col_off + c0: col_off + c0 + w]
        P = np.concatenate([[0], np.cumsum(cgt)])
        sub = colsub[col_off + c0: col_off + c0 + w] - rg - cgt[:, None]
        if tr == 0:
            topdp = top[top_off + c0: top_off + c0 + w + 1].astype(np.int64)
        else:
            topdp = H[tr, c0: c0 + w + 1].copy()
            if c0 == 0:
                topdp[0] = j0 * eg
        assert (topdp != unset).all()
        prev = topdp - P
        for r in range(h):
            j = j0 + 1 + r
            leftdp = j * eg if tc == 0 else V[tc, j]
            assert leftdp != unset
            b = codes[code_off + j - 1]
            b = 4 if b < 0 or b > 4 else b
            cand = prev[:-1] + sub[:, b]
            cur = np.maximum.accumulate(np.concatenate(
                [[leftdp - (r + 1) * rg], np.maximum(cand, prev[1:])]))
            old, v = cur[:-1], cur[1:]
            left_wins = cand < old
            up_wins = np.maximum(cand, old) < prev[1:]
            word, bit = profile.dirs_address(R, C, j, c0 + 1 + np.arange(w))
            dirs[word_off[g] + word] |= (
                (left_wins << bit) | (up_wins << (bit + S))).astype(np.uint32)
            if tc + 1 < ntc:
                V[tc + 1, j] = v[-1] + (r + 1) * rg + P[w]
            prev = cur
        if tr + 1 < ntr:
            H[tr + 1, c0 + 1: c0 + w + 1] = prev[1:] + h * rg + P[1:]
        flags[flag_off + tile] = True
    assert flags.all()
    paths = []
    for g, (R, C) in enumerate(zip(rr.tolist(), cc.tolist())):
        out, j, c = [], R, C
        while j > 0 and c > 0:
            word, bit = profile.dirs_address(R, C, j, c)
            bits = int(dirs[word_off[g] + word]) >> int(bit)
            d = (profile.D_UP if (bits >> S) & 1
                 else profile.D_LEFT if bits & 1 else profile.D_DIAG)
            out.append(d)
            j -= d != profile.D_LEFT
            c -= d != profile.D_UP
        out += [profile.D_UP] * j + [profile.D_LEFT] * c
        paths.append(np.asarray(out, dtype=np.int8))
    return paths


def _twin_items(name, Tr, Tc):
    rng = np.random.default_rng(len(name))
    sc = dict(match=1, mismatch=-1, indel=-1, doublegap=0)
    stale = lambda R, C: _stale_shape(rng, R, C)  # noqa: E731
    if name == "tile_edges":
        items = [stale(R, C) for R, C in [
            (Tr, Tc), (Tr + 1, Tc + 1), (Tr - 1, Tc - 1), (2 * Tr, 3 * Tc),
            (2 * Tr + 1, 3 * Tc - 1)]]
    elif name == "thin_and_small":
        items = [stale(1, 3 * Tc + 5), stale(2 * Tr + 3, 1), stale(1, 1),
                 stale(Tr // 3, Tc // 2)]
    elif name == "giant_among_tiny":
        items = [stale(int(rng.integers(1, 9)), int(rng.integers(1, 9)))
                 for _ in range(12)]
        items.insert(5, stale(3 * Tr + 17, 11 * Tc + 3))
    elif name == "fresh_default":
        items = [_fresh(rng, Tr + 40, 3 * Tc + 7, 9, 5),
                 _fresh(rng, 2 * Tr, 2 * Tc, 3, 3)]
    else:  # non-default scoring, i = 64, stale boundaries
        sc = dict(match=2, mismatch=-3, indel=-2, doublegap=-1)
        items = [stale(Tr + 9, 4 * Tc + 1), stale(2 * Tr - 1, Tc + 2)]
        items = [(c, rng.integers(0, 65, size=s.shape), 64, t, e)
                 for c, s, _, t, e in items]
    return items, sc


def _stale_shape(rng, R, C):
    i = int(rng.integers(1, 17))
    return (rng.integers(0, 4, size=R).astype(np.int64),
            rng.integers(0, i + 1, size=(C, 5)).astype(np.int64), i,
            rng.integers(-60, 10, size=C + 1).astype(np.int64),
            int(rng.integers(-20, 0)))


@pytest.mark.parametrize("name", ["tile_edges", "thin_and_small",
                                  "giant_among_tiny", "fresh_default",
                                  "scoring_i64_stale"])
def test_tiled_twin_matches_plain(name, small_tiles):
    items, sc = _twin_items(name, *small_tiles)
    want = profile.profile_paths(items, "cpu", **sc)
    for got, w in zip(_tiled_twin(items, **sc), want):
        np.testing.assert_array_equal(got, w)


@pytest.mark.parametrize("name", ["stale0", "stale3", "fresh_64x200", "i64",
                                  "shape_1x40", "shape_40x1",
                                  "shape_513x511"])
def test_plain_matches_native_host_path(name, pallas_default):
    """The CPU route, the Pallas kernel (interpret mode) and the JAX
    package's native host fill agree on the same seeded item."""
    item = DEFAULT_CASES[name]
    got = profile.profile_paths([item], "cpu")[0]
    score_path = jnative.dp_fill_path(*item)
    assert score_path is not None
    np.testing.assert_array_equal(got, score_path[1])
    np.testing.assert_array_equal(got, pallas_default[name])
