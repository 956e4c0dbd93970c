"""Peaks of one NVIDIA H100 SXM and the least time of a kernel call,
frozen from ``chip_smoke.py`` (:176-205) so that the yardstick stays
where later changes to the program cannot move it.

A call's bound is the larger of its bytes over the memory rate and its
int32 operations over the int32 rate.  Bytes count each input read once
and each output written once; operations count what these inputs need.
"""

from __future__ import annotations

from typing import Iterable, Tuple

# HBM3 bytes/s: NVIDIA's H100 SXM data sheet, at its 700 W limit
MEM_BYTES_PER_S = 3.35e12
# int32 operations/s, derived and not published: 132 SMs x 64 INT32
# lanes x 1.98 GHz boost clock (the Hopper SM layout)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int32 operations a profile-DP cell: three moves, three compares and
# four selects (value and direction code; csrc/profile_dp.cu)
PROFILE_OPS_PER_CELL = 10


def bound_s(nbytes: float, ops: float) -> float:
    """Least seconds for ``nbytes`` bytes and ``ops`` int32 operations."""
    return max(nbytes / MEM_BYTES_PER_S, ops / INT32_OPS_PER_S)


def mscan_bound_s(M: int, N: int, reduce: bool) -> float:
    """An (M, N) int32 scan: M x N read, M x N (or N, reduced over the
    channels) written, one max or min an element."""
    return bound_s(4 * (M * N + (N if reduce else M * N)), M * N)


def profile_bound_s(shapes: Iterable[Tuple[int, int]]) -> float:
    """One profile-DP launch over gaps of R rows and C columns: codes
    (1 B a row), score vector (5 x 4 B a column), top row (4 B a column)
    and the path (1 B a step) move; 10 operations a cell."""
    shapes = list(shapes)
    nbytes = sum(R + 24 * C + 4 + (R + C) for R, C in shapes)
    cells = sum(R * C for R, C in shapes)
    return bound_s(nbytes, PROFILE_OPS_PER_CELL * cells)
