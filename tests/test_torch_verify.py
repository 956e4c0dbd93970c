"""The port's exhaustive index checker (csa_tpu_torch.index.verify) on the
port's own host index (csa_tpu_torch.index.cyclic), modelled on
tests/test_index_invariants.py: random circular families, homopolymers
and periodic sets, mixed and short lengths, and a corrupted lcp.  It
also holds the index that the port's device build gives, single-device
and over a 4-rank CPU mesh, to the same invariants, and checks that the
port's copy reports what the JAX package's checker reports."""

import numpy as np
import pytest
import torch

from csa_tpu.index import cyclic as jcyclic
from csa_tpu.index import verify as jverify
from csa_tpu_torch.index import cyclic, engine, verify
from csa_tpu_torch.parallel import dsort_ladder
from csa_tpu_torch.parallel.sharded import make_mesh

torch.set_num_threads(1)


def _check(encoded):
    index = cyclic.build_rotation_index(encoded)
    verify.verify_index(index, encoded)
    blocks = cyclic.collect_blocks(index)
    verify.verify_blocks(index, blocks, encoded)
    return index, blocks


def _families(seed, trials=5):
    rng = np.random.default_rng(seed)
    for _ in range(trials):
        k = int(rng.integers(2, 5))
        n = int(rng.integers(12, 60))
        base = rng.integers(0, 4, size=n, dtype=np.int64)
        encoded = []
        for _ in range(k):
            row = np.roll(base, int(rng.integers(0, n))).copy()
            for _ in range(2):
                row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
            encoded.append(row)
        yield encoded


def test_random_circular_families():
    for encoded in _families(42):
        _check(encoded)


def test_homopolymers_and_periodic():
    _check([np.zeros(16, dtype=np.int64), np.zeros(24, dtype=np.int64)])
    _check([np.tile([0, 1], 10).astype(np.int64),
            np.tile([0, 1, 2], 8).astype(np.int64)])


def test_mixed_lengths_and_short():
    _check([np.array([0, 1, 2, 3], dtype=np.int64),
            np.array([0, 1, 2, 3, 0, 1], dtype=np.int64),
            np.array([2, 3, 0, 1, 3], dtype=np.int64)])


def _corrupted():
    encoded = [np.array([0, 1, 2, 3, 1], dtype=np.int64),
               np.array([1, 2, 3, 1, 0], dtype=np.int64)]
    return encoded


def test_checker_catches_corruption():
    encoded = _corrupted()
    index = cyclic.build_rotation_index(encoded)
    bad = np.array(index.lcp)
    bad[3] += 1
    index.lcp = bad
    with pytest.raises(verify.IndexInvariantError, match=r"lcp\[3\]"):
        verify.verify_index(index, encoded)


def test_checker_reports_as_the_jax_checker():
    """The same corruption of the same index: both checkers raise the same
    message."""
    encoded = _corrupted()
    msgs = []
    for cyc, ver in ((cyclic, verify), (jcyclic, jverify)):
        index = cyc.build_rotation_index(encoded)
        index.lcp = np.array(index.lcp)
        index.lcp[3] += 1
        with pytest.raises(ver.IndexInvariantError) as err:
            ver.verify_index(index, encoded)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _as_index(order, lcp, encoded, n_max):
    """The device build's padded (order, lcp) as a host RotationIndex:
    padded slots sort last, so the real rotations are the first M."""
    sizes = np.array([len(e) for e in encoded])
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    M = int(offsets[-1])
    order = order.cpu().numpy()[:M]
    return cyclic.RotationIndex(
        seq_of=np.repeat(np.arange(len(sizes)), sizes),
        pos_of=np.concatenate([np.arange(n) for n in sizes]),
        n_of=np.repeat(sizes, sizes), offsets=offsets, levels=[],
        sa=offsets[order // n_max] + order % n_max,
        lcp=lcp.cpu().numpy()[:M], num_seqs=len(sizes))


@pytest.mark.parametrize("ranks", [None, 4])
def test_device_build_satisfies_invariants(ranks):
    for encoded in _families(7, trials=3):
        if ranks is None:
            arrays, aux = engine._device_build(encoded, "cpu")
        else:
            arrays, aux = dsort_ladder.device_build_dsort(
                encoded, make_mesh(ranks, devices=["cpu"]))
        order, lcp, _ = arrays
        verify.verify_index(_as_index(order, lcp, encoded, aux[1]), encoded)
