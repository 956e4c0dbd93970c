"""The port's shard-local prefix-doubling ladder
(csa_tpu_torch.parallel.dsort_ladder.device_build_dsort) on CPU meshes of
1, 2, 4 and 8 ranks: order, lcp and the level-0 group size against the
JAX package's ladder on its virtual CPU mesh and against the port's
single-device build; ragged lengths; duplicate rotations.  Integer
outputs, exact."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh as JaxMesh

from csa_tpu.parallel import dsort_ladder as jladder
from csa_tpu_torch.index import engine
from csa_tpu_torch.parallel import dsort_ladder
from csa_tpu_torch.parallel.sharded import make_mesh

torch.set_num_threads(1)


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


def _ragged_set():
    rng = np.random.default_rng(9)
    return [rng.integers(0, 4, size=int(rng.integers(500, 2500)))
            .astype(np.int64) for _ in range(6)]


def _jmesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(n, 1),
                   ("seq", "pos"))


def _mesh(n):
    return make_mesh(n, (n, 1), devices=[torch.device("cpu")])


def _assert_build_equal(got, want):
    (go, gl, _), gaux = got
    (wo, wl, _), waux = want
    assert tuple(gaux) == tuple(waux)
    np.testing.assert_array_equal(go.numpy(), np.asarray(wo))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_ladder_matches_jax_ladder_and_single_device(n_dev):
    enc = _circular_set(4, 1500, seed=3)
    got = dsort_ladder.device_build_dsort(enc, _mesh(n_dev))
    _assert_build_equal(got, engine._device_build(enc, "cpu"))
    _assert_build_equal(got, jladder.device_build_dsort(enc, _jmesh(n_dev)))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_ladder_ragged_lengths(n_dev):
    """Unequal lengths: padded slots in every shard, and shards that
    straddle two sequences."""
    enc = _ragged_set()
    got = dsort_ladder.device_build_dsort(enc, _mesh(n_dev))
    _assert_build_equal(got, engine._device_build(enc, "cpu"))
    if n_dev == 8:
        _assert_build_equal(got, jladder.device_build_dsort(enc,
                                                            _jmesh(8)))


def test_ladder_duplicate_rotations_return_none():
    rng = np.random.default_rng(4)
    base = rng.integers(0, 4, size=64).astype(np.int64)
    period = np.tile(base[:8], 8)
    enc = [period, np.roll(period, 3)]
    assert dsort_ladder.device_build_dsort(enc, _mesh(8)) == (None, None)
    assert engine._device_build(enc, "cpu") == (None, None)
    assert jladder.device_build_dsort(enc, _jmesh(8))[0] is None


def test_ladder_rounds_n_max_to_the_rank_count():
    """n_max is a multiple of the rank count, as in JAX; on meshes of up to
    1,024 ranks that is the single-device bucket itself."""
    enc = _circular_set(3, 700, seed=1)
    (_, _, _), (_, n_max, _) = dsort_ladder.device_build_dsort(enc,
                                                               _mesh(4))
    assert n_max == engine._bucket(700) and n_max % 4 == 0


def test_ladder_rejects_three_ranks():
    with pytest.raises(ValueError, match="power of two"):
        dsort_ladder.device_build_dsort(_circular_set(3, 300, seed=2),
                                        _mesh(3))
