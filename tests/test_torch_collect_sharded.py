"""The port's sharded collect front
(csa_tpu_torch.parallel.collect_sharded.collect_front) on CPU meshes of 1,
2 and 8 ranks: (collected, start, end) against the JAX package's
collect_front_program on its virtual CPU mesh and against the port's
single-device front, on an input with deep intervals (tdeep > 0); and
the full block stage over a mesh against the single-device one.
Integer outputs, exact."""

import io
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from csa_tpu.parallel import collect_sharded as jcollect
from csa_tpu_torch import kernels
from csa_tpu_torch.index import engine
from csa_tpu_torch.io import fasta as fio
from csa_tpu_torch.parallel import collect_sharded
from csa_tpu_torch.parallel.sharded import make_mesh

torch.set_num_threads(1)
FIX = pathlib.Path(__file__).resolve().parent / "fixtures"


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


def _mesh(n):
    return make_mesh(n, devices=[torch.device("cpu")])


@pytest.fixture(scope="module")
def built():
    enc = _circular_set(8, 2500, seed=5)
    (order, lcp, lengths), (k, n_max, mg0) = engine._device_build(enc, "cpu")
    tdeep = engine._tdeep_for(mg0, k, n_max)
    assert tdeep > 0 and int((lcp > 12).sum()) > 0
    kw = dict(k=k, n_max=n_max, tdeep=tdeep)
    want = engine._collect_front(order, lcp, lengths, pack_w=12, **kw)
    return order, lcp, lengths, kw, want


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_front_matches_jax_and_single_device(built, n_dev):
    order, lcp, lengths, kw, want = built
    kernels.reset_counts()
    got = collect_sharded.collect_front(_mesh(n_dev), order, lcp, lengths,
                                        pack_w=12, **kw)
    assert set(kernels.COUNTS.values()) == {0}   # the CPU's plain scans
    mesh = JaxMesh(np.asarray(jax.devices()[:n_dev]), ("x",))
    with jax.enable_x64():
        prog = jcollect.collect_front_program(mesh, **kw)
        jgot = prog(jnp.asarray(order.numpy().astype(np.int32)),
                    jnp.asarray(lcp.numpy().astype(np.int32)),
                    jnp.asarray(lengths.numpy().astype(np.int32)))
    assert int(got[0].sum()) > 0
    for g, w, j in zip(got, want, jgot):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("n_dev", [2, 4])
@pytest.mark.parametrize("name", ["tiny/a-repeat-0", "tiny/t8"])
def test_block_stage_over_a_mesh_matches_single_device(name, n_dev):
    enc = fio.load_fasta(str(FIX / f"{name}.txt"),
                         log=io.StringIO()).encoded_all()
    want = engine.rotation_final(enc, "cpu")
    got = engine.rotation_final(enc, "cpu", mesh=_mesh(n_dev))
    assert (got.num_collected, got.num_after_suffix) == \
        (want.num_collected, want.num_after_suffix)
    np.testing.assert_array_equal(got.final_start, want.final_start)
    np.testing.assert_array_equal(got.final_depth, want.final_depth)
    np.testing.assert_array_equal(got.final_positions, want.final_positions)
