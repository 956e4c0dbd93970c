"""Inputs of the mscan tests, in numpy only (the card tests import it on a
machine without JAX).

On i.i.d. values a running max or min sets a new record in tile t with
probability about 1/t, so past the first few tiles almost every output
equals the carry from the tiles before, and a fault inside a tile hides.
The other forms put records in every tile:

- ``cascade``: what the collect cascade feeds the kernel
  (``index/engine.py``): ``where(mask, arange(N), -1)`` for the max scan
  (PSV and the coverage call) and ``where(mask, arange(N), N)`` for the
  min scan (NSV), each channel with its own mask density;
- ``walk``: random walks that drift in the scan's direction (up for a
  forward max scan, down for a reverse one, the other way for a min
  scan), from nearby starts, so that records fall in every tile and the
  reduction over channels changes hands.
"""

import numpy as np

KINDS = ("uniform", "cascade", "walk")


def mscan_input(kind, M, N, *, is_min, reverse, seed):
    """An (M, N) int32 input of the given form for the max scan (or, with
    ``is_min``, the min scan) read forward (or with ``reverse``)."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return rng.integers(-(2**30), 2**30, size=(M, N)).astype(np.int32)
    if kind == "cascade":
        density = 0.5 ** (1 + np.arange(M) % 10)  # 1/2 down to 1/1024
        mask = rng.random((M, N)) < density[:, None]
        return np.where(mask, np.arange(N), N if is_min else -1).astype(
            np.int32)
    if kind == "walk":
        sign = (-1 if is_min else 1) * (-1 if reverse else 1)
        steps = rng.integers(-2, 4, size=(M, N)) * sign  # drift 1/2 a step
        start = rng.integers(-4096, 4096, size=(M, 1))
        return (start + np.cumsum(steps, axis=1)).astype(np.int32)
    raise ValueError(f"unknown mscan input kind {kind!r}")
