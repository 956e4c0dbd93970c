"""Maker of the Mbp sets: ``k`` circular sequences of ``n`` bases from
one uniformly random base, each rotated to a random start and given
``n // subst_per`` random substitutions (positions drawn with
replacement).  This is the JAX package's baseline Mbp set
(``bench.py`` ``_mbp_set``), written here in NumPy from the run's seed.
"""

from __future__ import annotations

import numpy as np

LETTERS = np.frombuffer(b"ACGT", dtype=np.uint8)


def make(params: dict, seed: int, path: str) -> None:
    """Write the set for ``seed`` to ``path`` as a FASTA file, one line a
    sequence, named ``s0`` .. ``s<k-1>``."""
    n, k = int(params["n"]), int(params["k"])
    nsub = n // int(params["subst_per"])
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    with open(path, "w") as f:
        for i in range(k):
            row = np.roll(base, int(rng.integers(0, n))).copy()
            idxs = rng.integers(0, n, size=nsub)
            row[idxs] = rng.integers(0, 4, size=nsub)
            f.write(f">s{i}\n{LETTERS[row].tobytes().decode()}\n")
