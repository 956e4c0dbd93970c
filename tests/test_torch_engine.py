"""Port index engine (csa_tpu_torch.index.engine) against the JAX engine
on the CPU: the staged build's ``order``/``lcp`` element for element, the
rotation block stage's slim result, the duplicate-rotation branch, and
the linear suffix order used by the anchors.  Integer outputs, exact."""

import io
import pathlib

import numpy as np
import pytest
import torch

from csa_tpu.index import engine as jengine
from csa_tpu.io import fasta as fio
from csa_tpu_torch import kernels
from csa_tpu_torch.index import engine

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

FIX = pathlib.Path(__file__).parent / "fixtures"
SETS = ["tiny/t1", "tiny/t8", "tiny/a-repeat-0", "Primates"]


def _encoded(name):
    seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    return seqs.encoded_all()


@pytest.mark.parametrize("name", SETS)
def test_device_build_order_lcp_match_jax(name):
    enc = _encoded(name)
    (jo, jl, _), jaux = jengine._device_build(enc)
    (to, tl, _), taux = engine._device_build(enc, "cpu")
    assert taux == jaux
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("name", SETS)
def test_rotation_final_matches_jax(name):
    enc = _encoded(name)
    want = jengine.rotation_final_jax(enc)
    kernels.reset_counts()
    got = engine.rotation_final(enc, "cpu")
    assert set(kernels.COUNTS.values()) == {0}
    assert got.num_collected == want.num_collected
    assert got.num_after_suffix == want.num_after_suffix
    np.testing.assert_array_equal(got.final_start, want.final_start)
    np.testing.assert_array_equal(got.final_depth, want.final_depth)
    np.testing.assert_array_equal(got.final_positions, want.final_positions)


def test_rotation_final_pack_w_matches_jax_engine_width():
    """A non-default packing width gives the same final blocks (the JAX
    engine's width is frozen at import, so compare with its default)."""
    enc = _encoded("tiny/t3")
    want = jengine.rotation_final_jax(enc)
    got = engine.rotation_final(enc, "cpu", pack_w=5)
    np.testing.assert_array_equal(got.final_start, want.final_start)
    np.testing.assert_array_equal(got.final_positions, want.final_positions)


def test_duplicate_rotations_return_none():
    enc = [np.array([0, 1, 2, 3] * 6), np.array([1, 2, 3, 0] * 6)]
    assert jengine.rotation_final_jax(enc) is None
    assert engine.rotation_final(enc, "cpu") is None


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_linear_suffix_order_matches_jax(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 6))
    parts = []
    for i in range(k):
        # homopolymer runs and repeats stress ties; separators i < k
        body = rng.integers(0, 4 if seed % 2 else 2,
                            size=int(rng.integers(5, 300)))
        parts += [body + k, [i]]
    s = np.concatenate(parts).astype(np.int64)
    want_sa, want_lcp = jengine.linear_suffix_order(s)
    got_sa, got_lcp = engine.linear_suffix_order(s, "cpu")
    np.testing.assert_array_equal(got_sa, want_sa)
    np.testing.assert_array_equal(got_lcp, want_lcp)


def test_tdeep_and_bucket_helpers_match_jax():
    for mg0, k, n_max in [(1, 2, 1024), (17, 4, 1024), (5000, 16, 17408)]:
        assert engine._tdeep_for(mg0, k, n_max) == \
            jengine._tdeep_for(mg0, k, n_max)
    assert engine._bucket(1_000_000) == jengine._bucket(1_000_000)
