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
from csa_tpu.align import progressive
from csa_tpu.dp import pallas_profile
from csa_tpu_torch import kernels
from csa_tpu_torch.dp import profile

torch.set_num_threads(1)

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

