"""The port's block-bitonic distributed sort (csa_tpu_torch.parallel.dsort)
on CPU meshes of 1-8 ranks: sharded_argsort against a numpy stable
argsort on the distributions of tests/test_dsort.py and against the JAX
package's on its virtual CPU mesh; net_sort_pairs on tied keys against
the JAX package's, pair for pair (the same tie rule gives the same
order); three ranks raise.  Integer outputs, exact."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

from csa_tpu.parallel import dsort as jdsort
from csa_tpu_torch.parallel import dsort
from csa_tpu_torch.parallel.sharded import Ranks, make_mesh

try:
    from jax import shard_map
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map

torch.set_num_threads(1)
DISTS = ["uniform", "ties", "presorted", "negative", "reverse"]


def _values(dist, seed, n=8 * 4096):
    rng = np.random.default_rng(seed)
    if dist == "uniform":
        return rng.integers(0, 1 << 28, size=n, dtype=np.int32)
    if dist == "ties":
        return rng.integers(0, 7, size=n, dtype=np.int32)
    if dist == "presorted":
        return np.sort(rng.integers(0, 500, size=n, dtype=np.int32))
    if dist == "negative":
        return rng.integers(-(2**31), 2**31 - 1, size=n, dtype=np.int32)
    return np.sort(rng.integers(0, 500, size=n, dtype=np.int32))[::-1].copy()


def _mesh(n):
    return make_mesh(n, devices=[torch.device("cpu")])


def _jmesh(n):
    return JaxMesh(np.asarray(jax.devices()[:n]), ("x",))


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
@pytest.mark.parametrize("dist", DISTS)
def test_sharded_argsort_is_the_stable_order(n_dev, dist):
    v = _values(dist, seed=n_dev * 10 + DISTS.index(dist))
    vals, order = dsort.sharded_argsort(v, _mesh(n_dev))
    want = np.argsort(v, kind="stable")
    np.testing.assert_array_equal(order.numpy(), want)
    np.testing.assert_array_equal(vals.numpy(), v[want])


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_argsort_matches_jax(n_dev):
    v = _values("ties", seed=3)
    jvals, jorder = jdsort.sharded_argsort(v, _jmesh(n_dev))
    vals, order = dsort.sharded_argsort(torch.from_numpy(v), _mesh(n_dev))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_net_sort_pairs_tied_keys_match_jax(n_dev):
    """Keys with heavy ties: both partners of each stage order ties the
    same way, so the payloads come out as the JAX package's do, and the
    pairs are a sorted permutation of the input."""
    rng = np.random.default_rng(n_dev)
    n = 8 * 1024
    keys = rng.integers(0, 5, size=n).astype(np.int64)
    pay = rng.permutation(n).astype(np.int32)
    S = n // n_dev
    with jax.enable_x64():
        prog = jax.jit(shard_map(
            lambda u, p: jdsort.net_sort_pairs(u, p, "x", n_dev),
            mesh=_jmesh(n_dev), in_specs=(P("x"), P("x")),
            out_specs=(P("x"), P("x"))))
        ju, jp = (np.asarray(a) for a in prog(jnp.asarray(keys),
                                              jnp.asarray(pay)))
    us, ps = dsort.net_sort_pairs(
        Ranks(_mesh(n_dev)),
        [torch.from_numpy(keys[r * S:(r + 1) * S]) for r in range(n_dev)],
        [torch.from_numpy(pay[r * S:(r + 1) * S]) for r in range(n_dev)])
    u, p = torch.cat(us).numpy(), torch.cat(ps).numpy()
    key_of = np.empty(n, np.int64)
    key_of[pay] = keys
    np.testing.assert_array_equal(u, np.sort(keys))
    np.testing.assert_array_equal(key_of[p], u)
    np.testing.assert_array_equal(np.sort(p), np.arange(n))
    np.testing.assert_array_equal(u, ju)
    np.testing.assert_array_equal(p, jp)


def test_three_ranks_raise():
    with pytest.raises(ValueError, match="power of two"):
        dsort.sharded_argsort(np.zeros(12, np.int32), _mesh(3))
    with pytest.raises(ValueError, match="power of two"):
        dsort.net_sort_pairs(Ranks(_mesh(3)), [torch.zeros(4)] * 3,
                             [torch.zeros(4)] * 3)
