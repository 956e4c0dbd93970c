"""Multi-MEM anchors (border nodes) over the rotated linear sequences
(counterpart of :mod:`csa_tpu.align.anchors`).

The linear suffix index has three routes, as in ``csa_tpu``: sorted on
``device`` by :func:`..index.engine.linear_suffix_order` (``device``),
by the native host library (``native``), or by the numpy
prefix-doubling twin (``numpy``, also the ``native`` route's fallback
when the library is missing).  The attachment statistics are host
sweeps, the native C++ kernel on the ``device`` and ``native`` routes
when it is built and otherwise the numpy twin, and so is the grouping
(``native.anchor_group``, or its twin ``_group_border_nodes``).  The
host parts (:class:`BorderNode`,
:class:`LinearIndex`, the sweeps and the grouping) are the port's own
copies of those in ``csa_tpu.align.anchors``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from .. import native
from ..index import engine
from ..utils import PROFILER

__all__ = ["BorderNode", "build_linear_index", "compute_border_nodes"]


@dataclass
class BorderNode:
    """A Multi-MEM anchor candidate (reference: morenodeslinkedlists.h:11-22).

    ``positions[i]`` are the sorted occurrence starts in rotated sequence
    ``i`` coordinates; ``size`` is the string depth.
    """

    size: int
    positions: List[np.ndarray]  # per sequence, ascending


@dataclass
class LinearIndex:
    """Suffix order of the rotated linear sequences.

    sa entries are (seq, pos) pairs flattened as seq * stride + pos over
    real positions only; ``lcp[i]`` is the (length-capped) LCP between
    entries ``i-1`` and ``i``.
    """

    seq_of: np.ndarray  # (M,) sequence id per sorted entry
    pos_of: np.ndarray  # (M,) rotated-coordinate suffix start per entry
    cap: np.ndarray  # (M,) suffix length per entry
    lcp: np.ndarray  # (M,) adjacent capped LCPs, lcp[0] = 0
    num_seqs: int



def build_linear_index(encoded_rotated: Sequence[np.ndarray], device=None,
                       backend: str = "device") -> LinearIndex:
    """Suffix order of the concatenated rotated sequences, with unique
    per-sequence separators (0..k-1) below every character code.
    ``backend`` is "device" (sorted on ``device``), "native" or
    "numpy"."""
    k = len(encoded_rotated)
    sizes = np.array([len(e) for e in encoded_rotated], dtype=np.int64)
    total = int(sizes.sum()) + k
    s = np.empty(total, dtype=np.int64)
    offsets = np.zeros(k + 1, dtype=np.int64)
    at = 0
    for i, e in enumerate(encoded_rotated):
        offsets[i] = at
        s[at : at + len(e)] = np.asarray(e, dtype=np.int64) + k
        s[at + len(e)] = i
        at += len(e) + 1
    offsets[k] = at

    if backend == "device":
        sa_all, lcp_all = engine.linear_suffix_order(s, device)
    elif backend == "native" and (res := native.linear_index(s, k + 5)):
        sa_all, lcp_all = res
    else:
        return _linear_index_numpy(s, offsets, sizes, k)
    # the k separator suffixes sort first; dropping them keeps adjacency
    # among the rest, and the new first entry's lcp is 0 by definition
    sa = sa_all[k:].astype(np.int64)
    lcp = lcp_all[k:].astype(np.int64)
    if len(lcp):
        lcp[0] = 0
    seq_of = np.searchsorted(offsets, sa, side="right") - 1
    pos_of = sa - offsets[seq_of]
    cap = sizes[seq_of] - pos_of
    return LinearIndex(seq_of=seq_of, pos_of=pos_of, cap=cap, lcp=lcp,
                       num_seqs=k)


def _linear_index_numpy(s: np.ndarray, offsets: np.ndarray,
                        sizes: np.ndarray, k: int) -> LinearIndex:
    """The numpy prefix-doubling twin (csa_tpu/align/anchors.py:119-167):
    rank levels until every suffix is alone, then adjacent LCPs by binary
    descent over them."""
    total = len(s)
    rank = s.copy()
    levels = [rank.copy()]
    length = 1
    while length < total:
        shifted = np.full(total, -1, dtype=np.int64)
        shifted[: total - length] = rank[length:]
        order = np.lexsort((shifted, rank))
        r1 = rank[order]
        r2 = shifted[order]
        newgrp = np.ones(total, dtype=np.int64)
        newgrp[0] = 0
        newgrp[1:] = ((r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])).astype(np.int64)
        dense = np.cumsum(newgrp)
        rank = np.empty(total, dtype=np.int64)
        rank[order] = dense
        levels.append(rank.copy())
        length *= 2
        if dense[-1] == total - 1:
            break

    sa = np.argsort(levels[-1], kind="stable")
    # drop separator suffixes (they sort first: ranks of values 0..k-1)
    is_sep = np.zeros(total, dtype=bool)
    is_sep[offsets[1:] - 1] = True
    sa = sa[~is_sep[sa]]
    m = len(sa)

    # adjacent LCPs by binary descent over the rank levels; separators are
    # unique so matches terminate at sequence ends automatically
    lcp = np.zeros(m, dtype=np.int64)
    if m > 1:
        a = sa[:-1]
        b = sa[1:]
        off = np.zeros(m - 1, dtype=np.int64)
        for t in range(len(levels) - 1, -1, -1):
            step = np.int64(1 << t)
            ga = a + off
            gb = b + off
            ok = (ga < total) & (gb < total)
            eq = ok & (levels[t][np.minimum(ga, total - 1)]
                       == levels[t][np.minimum(gb, total - 1)])
            off = np.where(eq, off + step, off)
        lcp[1:] = off

    seq_of = np.searchsorted(offsets, sa, side="right") - 1
    pos_of = sa - offsets[seq_of]
    cap = sizes[seq_of] - pos_of
    return LinearIndex(seq_of=seq_of, pos_of=pos_of, cap=cap, lcp=lcp,
                       num_seqs=k)


def _segmented_running_min(values: np.ndarray, seg_ids: np.ndarray) -> np.ndarray:
    """Running min of ``values`` within segments of non-decreasing ids."""
    m = len(values)
    if m == 0:
        return values
    out = values.astype(np.int64)
    # band trick: subtract seg_id * B (B > value range) so each segment's
    # values live in a disjoint decreasing band; a global running min then
    # never crosses bands upward, which is exactly a per-segment reset.
    B = np.int64(1 << 40)
    banded = out - seg_ids.astype(np.int64) * B
    acc = np.minimum.accumulate(banded)
    return acc + seg_ids.astype(np.int64) * B


def _nearest_le_threshold(values: np.ndarray, thresh: np.ndarray):
    """For each index x: Lb = largest j <= x with values[j] <= thresh[x],
    and Rb = smallest j > x with values[j] <= thresh[x] (may be M, the
    virtual 0 sentinel).  Range-min sparse table + binary descent."""
    m = len(values)
    tables = [values.astype(np.int64)]
    t = 0
    while (1 << (t + 1)) <= m:
        prev = tables[-1]
        half = 1 << t
        tables.append(np.minimum(prev[: m - 2 * half + 1], prev[half : m - half + 1]))
        t += 1
    ntab = len(tables)
    idx = np.arange(m, dtype=np.int64)

    # Lb: grow the run (x-len .. x] keeping min(values) > thresh
    ln = np.zeros(m, dtype=np.int64)
    for tt in range(ntab - 1, -1, -1):
        half = np.int64(1 << tt)
        j = idx - ln - half + 1  # window [j, j+half) ending at x-ln
        ok = j >= 0
        mv = np.where(ok, tables[tt][np.maximum(j, 0)], np.int64(-1))
        grow = ok & (mv > thresh)
        ln = np.where(grow, ln + half, ln)
    lb = idx - ln
    # values[0] = 0 <= thresh always, so lb >= 0

    rn = np.zeros(m, dtype=np.int64)
    for tt in range(ntab - 1, -1, -1):
        half = np.int64(1 << tt)
        j = idx + rn + 1
        ok = (j + half - 1) <= (m - 1)  # window [j, j+half) inside array
        jc = np.clip(j, 0, max(m - int(half), 0))
        mv = np.where(ok, tables[tt][jc], np.int64(-1))
        grow = ok & (mv > thresh)
        rn = np.where(grow, rn + half, rn)
    rb = idx + rn + 1  # may be m (virtual 0 sentinel)
    return lb, rb



def _attach_numpy(idx: LinearIndex):
    """Matching statistic and attachment depth by numpy sweeps (the twin
    of ``native.anchor_attach``)."""
    k = idx.num_seqs
    m = len(idx.lcp)
    seq, cap, lcp = idx.seq_of, idx.cap, idx.lcp
    INF = np.int64(1 << 60)
    mstat = np.full(m, INF, dtype=np.int64)
    lcp_up = np.concatenate([lcp[1:], [np.int64(0)]])
    for j in range(k):
        is_j = seq == j
        grp = np.cumsum(is_j)
        down = _segmented_running_min(np.where(is_j, INF, lcp), grp)
        down = np.where((grp > 0) & ~is_j, down, np.where(is_j, INF, -1))
        rev_is = is_j[::-1]
        rgrp = np.cumsum(rev_is)
        up = _segmented_running_min(np.where(rev_is, INF, lcp_up[::-1]),
                                    rgrp)[::-1]
        has_below = (np.cumsum(is_j[::-1])[::-1] - is_j) > 0
        up = np.where(has_below & ~is_j, up, np.where(is_j, INF, -1))
        mj = np.where(is_j, INF, np.maximum(down, up))
        mstat = np.minimum(mstat, np.maximum(mj, 0))
    mstat = np.minimum(mstat, cap)
    lb, rb = _nearest_le_threshold(lcp, mstat)
    lcp_ext = np.concatenate([lcp, [np.int64(0)]])
    att = np.maximum(lcp_ext[lb], lcp_ext[rb])
    lb2, _ = _nearest_le_threshold(lcp, att - 1)
    return att, lb2


def compute_border_nodes(encoded_rotated: Sequence[np.ndarray], device=None,
                         backend: str = "device") -> List[BorderNode]:
    """All border nodes with their per-sequence position lists, the index
    built on ``backend``'s route (:func:`build_linear_index`).  The
    ``numpy`` route keeps the attachment statistics in numpy too, as
    ``csa_tpu`` does."""
    with PROFILER.phase("align.anchors.sort"):
        idx = build_linear_index(encoded_rotated, device, backend)
    with PROFILER.phase("align.anchors.attach"):
        res = None
        if backend != "numpy":
            res = native.anchor_attach(idx.seq_of, idx.lcp, idx.cap,
                                       idx.num_seqs)
        att, lb2 = res if res is not None else _attach_numpy(idx)
    with PROFILER.phase("align.anchors.group"):
        runs = None
        if backend != "numpy":
            runs = native.anchor_group(idx.seq_of, idx.pos_of, att, lb2,
                                       idx.num_seqs)
        if runs is None:
            nodes = _group_border_nodes(idx, att, lb2)
        else:
            nodes = _border_nodes_from_runs(*runs[:3], idx.num_seqs)
    grouped = runs[3] if runs is not None else int(np.count_nonzero(att >= 1))
    PROFILER.add("anchors.grouped_entries", grouped)
    PROFILER.add("anchors.border_nodes", len(nodes))
    return nodes


def _border_nodes_from_runs(depths: np.ndarray, offsets: np.ndarray,
                            positions: np.ndarray, k: int) -> List[BorderNode]:
    """:class:`BorderNode` lists from ``native.anchor_group``'s flat
    arrays: one ``tolist`` of the positions, cut by the offsets into k
    runs a node.  The loops are ``map`` calls: no bytecode runs while
    the tens of thousands of run lists are made, so the cyclic collector,
    which Python 3.12 starts only between bytecodes, passes over them
    once rather than every 700 allocations (on Primates 10 young and 1
    middle collection against 89 and 8, and at times a full one, for a
    list comprehension)."""
    flat = positions.tolist()
    offs = offsets.tolist()
    runs = list(map(flat.__getitem__, map(slice, offs[:-1], offs[1:])))
    n = len(depths)
    per_node = map(runs.__getitem__,
                   map(slice, range(0, n * k, k), range(k, n * k + 1, k)))
    return list(map(BorderNode, depths.tolist(), per_node))


def _group_border_nodes(
    idx: LinearIndex, att: np.ndarray, lb2: np.ndarray
) -> List[BorderNode]:
    """Group suffix entries into border nodes by (interval, depth)."""
    k = idx.num_seqs
    seq = idx.seq_of
    valid = att >= 1

    nodes: List[BorderNode] = []
    if not np.any(valid):
        return nodes
    krot = idx.pos_of
    order = np.lexsort((krot, seq, att, lb2))
    order = order[valid[order]]
    l_o = lb2[order]
    a_o = att[order]
    s_o = seq[order]
    k_o = krot[order]
    group_break = np.ones(len(order), dtype=bool)
    group_break[1:] = (l_o[1:] != l_o[:-1]) | (a_o[1:] != a_o[:-1])
    group_ids = np.cumsum(group_break) - 1
    num_groups = int(group_ids[-1]) + 1 if len(group_ids) else 0
    if num_groups == 0:
        return nodes
    # vectorized split: entries are sorted by (group, seq, pos), so each
    # (group, seq) run is one contiguous slice
    seq_break = group_break | np.concatenate([[True], s_o[1:] != s_o[:-1]])
    run_starts = np.nonzero(seq_break)[0]
    run_ends = np.concatenate([run_starts[1:], [len(order)]])
    run_group = group_ids[run_starts]
    run_seq = s_o[run_starts]
    # keep only groups covering all k sequences
    seqs_per_group = np.bincount(run_group, minlength=num_groups)
    full = seqs_per_group == k
    depths = np.zeros(num_groups, dtype=np.int64)
    depths[group_ids] = a_o
    run_keep = full[run_group]
    rs = run_starts[run_keep]
    re = run_ends[run_keep]
    rg = run_group[run_keep]
    cuts = np.nonzero(np.concatenate([[True], rg[1:] != rg[:-1]]))[0]
    # emit plain int lists: the list machine consumes them directly, and
    # slicing one materialized Python list beats creating thousands of
    # tiny numpy views + per-node tolist conversions downstream
    k_o_list = k_o.tolist()
    rs_l = rs.tolist()
    re_l = re.tolist()
    for t, cut in enumerate(cuts):
        nxt = cuts[t + 1] if t + 1 < len(cuts) else len(rs)
        positions = [k_o_list[rs_l[r] : re_l[r]] for r in range(cut, nxt)]
        nodes.append(
            BorderNode(size=int(depths[rg[cut]]), positions=positions)
        )
    return nodes
