"""Generalized cyclic suffix-array engine (numpy backend).

This module is the TPU-first replacement for the reference's generalized
cyclic suffix tree (``source/gencycsuffixtrees.c``). The
reference builds a pointer-linked Ukkonen tree over all rotations of all
sequences; pointer chasing is hostile to TPUs, so this engine reproduces the
*observable contract* of that tree with sort/scan/gather primitives:

1. every rotation of every sequence is an entry; rotations are compared as
   **periodic** (infinite) strings via prefix-doubling rank sorts;
2. identical rotations *within one sequence* collapse to a single entry that
   keeps the smallest start position — exactly like the reference tree where
   identical rotations share one leaf whose ``rotation`` field records the
   first (smallest) start (gencycsuffixtrees.c:206,484-496);
3. adjacent entries get an LCP **capped at the shorter sequence length**,
   which models the fact that a tree leaf at depth ``n`` terminates the path;
4. every internal tree node (branching string, or a full-rotation node) is an
   lcp-interval: a maximal run of entries with capped LCP >= d whose internal
   minimum equals d.  These are enumerated via previous/next-smaller-value
   queries on the LCP array;
5. "belongs to all sequences" (gencycsuffixtrees.c:33-37 nodeFromAllSeqs)
   becomes an interval coverage test, and the reference's "deepest node from
   all sequences" (csamsa.c:69-81 collectNodes) becomes:
   ``allseq(v) and no child interval of v is allseq`` — equivalent because a
   right-extension class of v covers all sequences iff the corresponding
   child interval does, and an all-seq child class always has >= 2 members,
   hence is itself an enumerated interval.

All arrays are flat int32/int64 numpy.  The port's copy of
:mod:`csa_tpu.index.cyclic`, without the JAX engine's device-rank
branches: the port takes this exact host index for inputs with duplicate
rotations (:mod:`csa_tpu_torch.rotation.pipeline`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class RotationIndex:
    """Sorted index over all (deduplicated) rotations of a sequence set.

    Attributes
    ----------
    seq_of, pos_of, n_of:
        per *global rotation id* ``g`` (0 <= g < N = sum of lengths): the
        sequence index, start position, and sequence length.
    offsets:
        start of each sequence's rotation-id range (len K+1).
    levels:
        ``levels[t][g]`` = dense rank of the cyclic prefix of length ``2**t``
        of rotation ``g``. ``levels[0]`` are the character codes' ranks.
    sa:
        global rotation ids of the kept (deduplicated) rotations, in sorted
        (periodic-lexicographic) order; length M <= N.
    lcp:
        ``lcp[i]`` = capped LCP of ``sa[i-1]`` and ``sa[i]`` (``lcp[0] = 0``),
        capped at ``min(n_of[sa[i-1]], n_of[sa[i]])``.
    raw_lcp:
        the same LCPs before the length cap (periodic match length); the
        linear-suffix view of the alignment phase re-caps these at suffix
        lengths.
    """

    seq_of: np.ndarray
    pos_of: np.ndarray
    n_of: np.ndarray
    offsets: np.ndarray
    levels: List[np.ndarray]
    sa: np.ndarray
    lcp: np.ndarray
    num_seqs: int
    raw_lcp: np.ndarray = None

    def advance(self, g: np.ndarray, off) -> np.ndarray:
        """Global id of rotation ``g`` advanced ``off`` chars (cyclic)."""
        return self.offsets[self.seq_of[g]] + (self.pos_of[g] + off) % self.n_of[g]

    def lcp_pairs(self, a: np.ndarray, b: np.ndarray, raw: bool = False) -> np.ndarray:
        """Capped LCP of arbitrary rotation pairs (vectorized binary descent).

        With ``raw=True`` returns the periodic match length without the
        sequence-length cap.
        """
        a = np.asarray(a)
        b = np.asarray(b)
        off = np.zeros(a.shape, dtype=np.int64)
        for t in range(len(self.levels) - 1, -1, -1):
            length = np.int64(1) << t
            ga = self.advance(a, off)
            gb = self.advance(b, off)
            eq = self.levels[t][ga] == self.levels[t][gb]
            off = np.where(eq, off + length, off)
        if raw:
            return off
        cap = np.minimum(self.n_of[a], self.n_of[b])
        return np.minimum(off, cap)

    def prefix_fingerprint(self, g: np.ndarray, d: int) -> np.ndarray:
        """Exact fingerprint of the length-``d`` cyclic prefix of rotation
        ``g`` (d >= 1): equal fingerprints iff equal prefixes.  Uses the
        classic two-overlapping-power-of-two-windows rank pair.
        """
        g = np.asarray(g)
        t = int(d).bit_length() - 1
        r1 = self.levels[t][g]
        r2 = self.levels[t][self.advance(g, d - (1 << t))]
        n_plus = np.int64(len(self.seq_of) + 1)
        return r1 * n_plus + r2

    def prefix_fingerprint_mixed(self, g: np.ndarray, d: np.ndarray) -> np.ndarray:
        """Fingerprints with a per-element prefix length."""
        g = np.asarray(g, dtype=np.int64)
        d = np.asarray(d, dtype=np.int64)
        t = np.zeros(len(d), dtype=np.int64)
        dd = d.copy()
        while np.any(dd > 1):
            grow = dd > 1
            t[grow] += 1
            dd[grow] >>= 1
        r1 = np.empty(len(g), dtype=np.int64)
        r2 = np.empty(len(g), dtype=np.int64)
        g2 = self.advance(g, d - (np.int64(1) << t))
        for tt in np.unique(t):
            sel = t == tt
            r1[sel] = self.levels[int(tt)][g[sel]]
            r2[sel] = self.levels[int(tt)][g2[sel]]
        n_plus = np.int64(len(self.seq_of) + 1)
        return r1 * n_plus + r2


def build_rotation_index(encoded: Sequence[np.ndarray]) -> RotationIndex:
    """Build the sorted, deduplicated cyclic rotation index.

    ``encoded``: list of per-sequence code arrays (values in [0, alphabet)).
    """
    num_seqs = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    if np.any(sizes == 0):
        raise ValueError("empty sequence")
    offsets = np.zeros(num_seqs + 1, dtype=np.int64)
    np.cumsum(sizes, out=offsets[1:])
    total = int(offsets[-1])
    seq_of = np.repeat(np.arange(num_seqs, dtype=np.int64), sizes)
    pos_of = np.arange(total, dtype=np.int64) - offsets[seq_of]
    n_of = sizes[seq_of]

    codes = np.concatenate([np.asarray(e, dtype=np.int64) for e in encoded])

    def advance(g, off):
        return offsets[seq_of[g]] + (pos_of[g] + off) % n_of[g]

    # prefix-doubling ranks; levels[t] ranks cyclic prefixes of length 2^t
    max_n = int(sizes.max())
    num_levels = 1
    while (1 << (num_levels - 1)) < max_n:
        num_levels += 1
    levels: List[np.ndarray] = []
    # level 0: dense ranks of single characters
    rank = codes.copy()
    levels.append(rank)
    g_all = np.arange(total, dtype=np.int64)
    for t in range(num_levels - 1):
        length = np.int64(1) << t
        rank2 = rank[advance(g_all, length)]
        order = np.lexsort((rank2, rank))
        r1s = rank[order]
        r2s = rank2[order]
        new_group = np.ones(total, dtype=np.int64)
        new_group[0] = 0
        new_group[1:] = (r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])
        dense = np.cumsum(new_group)
        rank = np.empty(total, dtype=np.int64)
        rank[order] = dense
        levels.append(rank)

    final_rank = levels[-1]
    # sort rotations: periodic-lexicographic, ties by (seq, pos) for
    # determinism (ties are identical periodic strings)
    sa_full = np.lexsort((pos_of, seq_of, final_rank))

    # dedup identical rotations within one sequence: keep the smallest pos
    fr = final_rank[sa_full]
    sq = seq_of[sa_full]
    dup = np.zeros(total, dtype=bool)
    dup[1:] = (fr[1:] == fr[:-1]) & (sq[1:] == sq[:-1])
    sa = sa_full[~dup]

    idx = RotationIndex(
        seq_of=seq_of,
        pos_of=pos_of,
        n_of=n_of,
        offsets=offsets,
        levels=levels,
        sa=sa,
        lcp=np.zeros(len(sa), dtype=np.int64),
        num_seqs=num_seqs,
        raw_lcp=np.zeros(len(sa), dtype=np.int64),
    )
    if len(sa) > 1:
        raw = idx.lcp_pairs(sa[:-1], sa[1:], raw=True)
        idx.raw_lcp[1:] = raw
        cap = np.minimum(idx.n_of[sa[:-1]], idx.n_of[sa[1:]])
        idx.lcp[1:] = np.minimum(raw, cap)
    return idx


def _psv_nsv(values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized previous/next-strictly-smaller-value indices.

    ``psv[i]`` = largest j < i with values[j] < values[i] (or -1);
    ``nsv[i]`` = smallest j > i with values[j] < values[i] (or len).

    Monotonic-stack implementation (the numpy backend favors exactness and
    simplicity; the JAX backend uses a static-shape range-min formulation).
    """
    b = len(values)
    if b == 0:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    v = values.tolist()
    psv = np.empty(b, dtype=np.int64)
    nsv = np.empty(b, dtype=np.int64)
    stack: List[int] = []
    for i in range(b):
        vi = v[i]
        while stack and v[stack[-1]] >= vi:
            stack.pop()
        psv[i] = stack[-1] if stack else -1
        stack.append(i)
    stack.clear()
    for i in range(b - 1, -1, -1):
        vi = v[i]
        while stack and v[stack[-1]] >= vi:
            stack.pop()
        nsv[i] = stack[-1] if stack else b
        stack.append(i)
    return psv, nsv


@dataclass
class BlockSet:
    """Collected blocks: right-maximal strings common to all sequences.

    Mirrors the outcome of reference ``collectNodes`` (csamsa.c:69-81).
    ``start``/``end`` are member ranges into ``index.sa`` (inclusive);
    ``depth`` is the block length.
    """

    index: RotationIndex
    start: np.ndarray
    end: np.ndarray
    depth: np.ndarray

    def __len__(self) -> int:
        return len(self.depth)

    def member_counts(self) -> np.ndarray:
        """(num_blocks, K) occurrence counts per sequence (distinct-rotation
        leaves, exactly like the reference's collectPositions leaf counts,
        csamsa.c:114-123)."""
        idx = self.index
        k = idx.num_seqs
        m = len(idx.sa)
        seq_sorted = idx.seq_of[idx.sa]
        prefix = np.zeros((m + 1, k), dtype=np.int64)
        one_hot = np.zeros((m, k), dtype=np.int64)
        one_hot[np.arange(m), seq_sorted] = 1
        np.cumsum(one_hot, axis=0, out=prefix[1:])
        return prefix[self.end + 1] - prefix[self.start]

    def positions_if_unique(self) -> Tuple[np.ndarray, np.ndarray]:
        """For blocks occurring exactly once per sequence, their start
        positions: returns (unique_mask, positions (num_blocks, K))."""
        idx = self.index
        k = idx.num_seqs
        counts = self.member_counts()
        unique = np.all(counts == 1, axis=1)
        m = len(idx.sa)
        seq_sorted = idx.seq_of[idx.sa]
        prefix = np.zeros((m + 1, k), dtype=np.int64)
        one_hot = np.zeros((m, k), dtype=np.int64)
        one_hot[np.arange(m), seq_sorted] = 1
        np.cumsum(one_hot, axis=0, out=prefix[1:])
        positions = np.zeros((len(self), k), dtype=np.int64)
        pos_sorted = idx.pos_of[idx.sa]
        for ki in range(k):
            col = prefix[:, ki]
            # member index = first j in [start, end] from sequence ki:
            # col[j+1] == col[start] + 1
            target = col[self.start] + 1
            j = np.searchsorted(col, target, side="left") - 1
            positions[:, ki] = pos_sorted[j]
        return unique, positions


def collect_blocks(index: RotationIndex) -> BlockSet:
    """Enumerate all "deepest all-sequence" nodes (the collected blocks).

    Equivalent to reference ``collectNodes`` over the suffix tree
    (csamsa.c:69-81): nodes whose string occurs (cyclically) in every
    sequence and that have no all-sequence child.
    """
    idx = index
    m = len(idx.sa)
    k = idx.num_seqs
    lcp = idx.lcp  # lcp[i] between sa[i-1] and sa[i]; lcp[0] = 0
    # candidate nodes = distinct (PSV, NSV) intervals of boundaries with d>=1
    bounds = np.arange(1, m, dtype=np.int64)
    d = lcp[1:]
    keep = d >= 1
    bounds = bounds[keep]
    d = d[keep]
    if len(bounds) == 0:
        return BlockSet(idx, np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    # PSV/NSV over the full boundary-lcp array (index i corresponds to lcp[i],
    # i in [0, m); lcp[0]=0 acts as sentinel)
    psv, nsv = _psv_nsv(lcp)
    # interval of boundary i: members [psv[i] if >=0 else 0 ... nsv[i]-1]
    start = np.where(psv[bounds] >= 0, psv[bounds], 0)
    end = nsv[bounds] - 1
    # dedupe identical intervals (same node reached from several boundaries)
    order = np.lexsort((d, end, start))
    start, end, d = start[order], end[order], d[order]
    first = np.ones(len(start), dtype=bool)
    first[1:] = (start[1:] != start[:-1]) | (end[1:] != end[:-1])
    start, end, d = start[first], end[first], d[first]
    # NOTE: within one (start, end) interval all boundaries share the same
    # d = min lcp, so dedupe by (start, end) is enough.

    # coverage: per-sequence counts >= 1 for all sequences
    seq_sorted = idx.seq_of[idx.sa]
    prefix = np.zeros((m + 1, k), dtype=np.int64)
    one_hot = np.zeros((m, k), dtype=np.int64)
    one_hot[np.arange(m), seq_sorted] = 1
    np.cumsum(one_hot, axis=0, out=prefix[1:])
    counts = prefix[end + 1] - prefix[start]
    allseq = np.all(counts >= 1, axis=1)

    # parent of node (start,end,d): the interval of the larger flanking
    # boundary; a node is "deepest" iff no all-seq node has it as parent.
    # Equivalent: for each all-seq node u (except the shallowest covering
    # node), its parent interval pd = max(lcp[start], lcp[end+1]) extends to
    # the parent (pstart, pend); mark that parent as having an all-seq child.
    lcp_ext = np.concatenate([lcp, np.zeros(1, dtype=np.int64)])  # lcp[m] = 0
    left_d = lcp_ext[start]      # boundary into the interval start
    right_d = lcp_ext[end + 1]   # boundary just after the interval end
    parent_bound = np.where(left_d >= right_d, start, end + 1)
    parent_d = np.maximum(left_d, right_d)
    has_parent = parent_d >= 1
    pb = parent_bound[has_parent]
    pstart = np.where(psv[pb] >= 0, psv[pb], 0)
    pend = nsv[pb] - 1

    # map (pstart, pend) to node ids via the deduped (start, end) table
    node_key = start * np.int64(m + 1) + end
    parent_key = pstart * np.int64(m + 1) + pend
    node_order = np.argsort(node_key, kind="stable")
    sorted_keys = node_key[node_order]
    pidx = np.searchsorted(sorted_keys, parent_key)
    # every parent interval is itself a candidate node (its min lcp >= 1)
    parent_node = node_order[pidx]

    child_allseq = np.zeros(len(start), dtype=bool)
    src = allseq[has_parent]
    np.logical_or.at(child_allseq, parent_node[src], True)

    collected = allseq & ~child_allseq
    return BlockSet(idx, start[collected], end[collected], d[collected])


def remove_suffix_blocks(blocks: BlockSet) -> np.ndarray:
    """Mask of blocks that are NOT a proper suffix of another block.

    Set-level equivalent of reference ``removeSuffixNodes`` (csamsa.c:85-109),
    which walks suffix links of each deeper block and deletes matches.
    """
    idx = blocks.index
    nb = len(blocks)
    if nb == 0:
        return np.zeros(0, dtype=bool)
    depth = blocks.depth
    rep = idx.sa[blocks.start]  # representative occurrence of each block
    keep = np.ones(nb, dtype=bool)
    # group blocks by depth; for each distinct depth ds, fingerprint the
    # length-ds suffix of every strictly deeper block and match.  All
    # fingerprints are gathered in TWO batched queries (one for the
    # blocks' own prefixes, one for every (deeper block, ds) suffix) so
    # the accelerator backend pays two dispatches, not two per depth.
    distinct = np.unique(depth)
    own_fp = idx.prefix_fingerprint_mixed(rep, depth)
    qs_g: List[np.ndarray] = []
    qs_d: List[np.ndarray] = []
    groups: List[int] = []
    bounds = [0]
    for ds in distinct:
        ds = int(ds)
        deeper = np.nonzero(depth > ds)[0]
        if len(deeper) == 0:
            continue
        qs_g.append(idx.advance(rep[deeper], depth[deeper] - ds))
        qs_d.append(np.full(len(deeper), ds, dtype=np.int64))
        groups.append(ds)
        bounds.append(bounds[-1] + len(deeper))
    if not qs_g:
        return keep
    all_fp = idx.prefix_fingerprint_mixed(
        np.concatenate(qs_g), np.concatenate(qs_d)
    )
    for gi, ds in enumerate(groups):
        owners = np.nonzero(depth == ds)[0]
        suf_fp = all_fp[bounds[gi] : bounds[gi + 1]]
        is_suffix = np.isin(own_fp[owners], suf_fp)
        keep[owners[is_suffix]] = False
    return keep
