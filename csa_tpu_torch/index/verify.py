"""Exhaustive index invariant checker — the ``checkSuffixTree`` analog
(the port's copy of :mod:`csa_tpu.index.verify`, on the port's own
:mod:`csa_tpu_torch.index.cyclic`).

The reference verifies its cyclic suffix tree with an O(n^2)-per-sequence
walk over every rotation (gencycsuffixtrees.c:655-713: transitions exist,
sequence marks, suffix/backlink depth arithmetic, leaf rotation values).
The suffix-array engine's observable contract is different, so the
invariants are re-stated for the sorted-rotation index:

1. **permutation**: every (sequence, position) rotation appears in ``sa``
   exactly once (minus within-sequence duplicate rotations, which the
   engine deduplicates like gencycsuffixtrees.c:489-495 discards whole
   duplicate sequences);
2. **sorted order**: consecutive ``sa`` entries are periodic-
   lexicographically non-decreasing, compared brute-force;
3. **LCP**: ``lcp[i]`` equals the brute-force common-prefix length of the
   adjacent rotations, capped at ``min(n_a, n_b)``; ``raw_lcp`` equals the
   uncapped periodic match length (up to the engine's horizon);
4. **interval coverage** (block invariants, csamsa.c:69-81 semantics):
   every collected block's members share the length-``depth`` prefix, the
   interval is maximal in both directions, and members from every
   sequence are present.

Intended for property tests on small/degenerate inputs (homopolymers,
periodic strings, duplicate rotations) — everything is materialized
brute-force, so keep total length in the thousands.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from . import cyclic


class IndexInvariantError(AssertionError):
    pass


def _rotation_string(encoded, index, g: int, horizon: int) -> np.ndarray:
    """The periodic expansion of rotation ``g`` to ``horizon`` chars."""
    s = int(index.seq_of[g])
    p = int(index.pos_of[g])
    seq = np.asarray(encoded[s])
    rolled = np.concatenate([seq[p:], seq[:p]])
    reps = -(-horizon // len(rolled))
    return np.tile(rolled, reps)[:horizon]


def _brute_match_len(a: np.ndarray, b: np.ndarray) -> int:
    m = min(len(a), len(b))
    neq = np.nonzero(a[:m] != b[:m])[0]
    return int(neq[0]) if len(neq) else m


def verify_index(
    index: cyclic.RotationIndex, encoded: Sequence[np.ndarray]
) -> None:
    """Raise :class:`IndexInvariantError` on any violated invariant."""
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    horizon = 2 * int(sizes.max())

    # --- 1. permutation over non-duplicate rotations ---
    seen = set()
    for i, g in enumerate(index.sa):
        key = (int(index.seq_of[g]), int(index.pos_of[g]))
        if key in seen:
            raise IndexInvariantError(f"sa entry {i} repeats rotation {key}")
        seen.add(key)
    for s in range(k):
        n = int(sizes[s])
        strs = {}
        expect = 0
        for p in range(n):
            t = tuple(np.roll(np.asarray(encoded[s]), -p))
            if t not in strs:
                strs[t] = p
                expect += 1
        have = sum(1 for (ss, _) in seen if ss == s)
        if have not in (expect, n):
            raise IndexInvariantError(
                f"sequence {s}: {have} rotations indexed, expected {expect} "
                f"(deduplicated) or {n} (all)"
            )
        for p in range(n):
            t = tuple(np.roll(np.asarray(encoded[s]), -p))
            if strs[t] == p and (s, p) not in seen and have == expect:
                raise IndexInvariantError(
                    f"canonical rotation ({s}, {p}) missing from sa"
                )

    # --- 2 + 3. sorted order and LCP correctness ---
    m = len(index.sa)
    for i in range(1, m):
        ga, gb = int(index.sa[i - 1]), int(index.sa[i])
        a = _rotation_string(encoded, index, ga, horizon)
        b = _rotation_string(encoded, index, gb, horizon)
        ml = _brute_match_len(a, b)
        if ml < horizon and a[ml] > b[ml]:
            raise IndexInvariantError(
                f"sa entries {i-1},{i} out of order (mismatch at {ml})"
            )
        cap = int(min(index.n_of[ga], index.n_of[gb]))
        want = min(ml, cap)
        got = int(index.lcp[i])
        if got != want:
            raise IndexInvariantError(
                f"lcp[{i}] = {got}, brute force says {want}"
            )
        if index.raw_lcp is not None:
            raw = int(index.raw_lcp[i])
            # raw match length is exact below the horizon; at/above it the
            # engine may report any value >= horizon (periodic equality)
            if raw < horizon and raw != ml:
                if not (ml >= horizon):
                    raise IndexInvariantError(
                        f"raw_lcp[{i}] = {raw}, brute force says {ml}"
                    )
    if m and int(index.lcp[0]) != 0:
        raise IndexInvariantError("lcp[0] must be 0")


def verify_blocks(
    index: cyclic.RotationIndex,
    blocks: "cyclic.BlockSet",
    encoded: Sequence[np.ndarray],
) -> None:
    """Check collected-block invariants (deepest all-sequence intervals)."""
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    horizon = 2 * int(sizes.max())
    m = len(index.sa)
    for bi in range(len(blocks)):
        lo = int(blocks.start[bi])
        hi = int(blocks.end[bi])
        d = int(blocks.depth[bi])
        if not (0 <= lo <= hi < m) or d < 1:
            raise IndexInvariantError(f"block {bi}: bad interval/depth")
        ref = _rotation_string(encoded, index, int(index.sa[lo]), horizon)[:d]
        seqs_present = set()
        for i in range(lo, hi + 1):
            g = int(index.sa[i])
            got = _rotation_string(encoded, index, g, horizon)[:d]
            if not np.array_equal(got, ref):
                raise IndexInvariantError(
                    f"block {bi}: member {i} lacks the shared depth-{d} prefix"
                )
            seqs_present.add(int(index.seq_of[g]))
        if seqs_present != set(range(k)):
            raise IndexInvariantError(
                f"block {bi}: sequences {sorted(seqs_present)} != all {k}"
            )
        for j, side in ((lo - 1, "left"), (hi + 1, "right")):
            if 0 <= j < m:
                g = int(index.sa[j])
                got = _rotation_string(encoded, index, g, horizon)[:d]
                cap = int(index.n_of[g])
                if cap >= d and np.array_equal(got, ref):
                    raise IndexInvariantError(
                        f"block {bi}: interval not maximal on the {side}"
                    )
