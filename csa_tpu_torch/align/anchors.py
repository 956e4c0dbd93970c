"""Multi-MEM anchors (border nodes) over the rotated linear sequences
(counterpart of the device branch of :mod:`csa_tpu.align.anchors`).

The linear suffix index is sorted on ``device`` by
:func:`..index.engine.linear_suffix_order`; the attachment statistics are
host sweeps, the native C++ kernel when it is built and otherwise the
numpy twin, and the grouping is the JAX package's own
``_group_border_nodes``, exactly as ``csa_tpu.align.anchors`` does.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from csa_tpu import native
from csa_tpu.align.anchors import (
    BorderNode,
    LinearIndex,
    _group_border_nodes,
    _nearest_le_threshold,
    _segmented_running_min,
)

from ..index import engine

__all__ = ["BorderNode", "build_linear_index", "compute_border_nodes"]


def build_linear_index(encoded_rotated: Sequence[np.ndarray],
                       device) -> LinearIndex:
    """Suffix order of the concatenated rotated sequences, with unique
    per-sequence separators (0..k-1) below every character code."""
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

    sa_all, lcp_all = engine.linear_suffix_order(s, device)
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


def _attach_numpy(idx: LinearIndex):
    """Matching statistic and attachment depth by numpy sweeps (the twin
    of ``native.anchor_attach``, csa_tpu/align/anchors.py:251-288)."""
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


def compute_border_nodes(encoded_rotated: Sequence[np.ndarray],
                         device) -> List[BorderNode]:
    """All border nodes with their per-sequence position lists."""
    idx = build_linear_index(encoded_rotated, device)
    res = native.anchor_attach(idx.seq_of, idx.lcp, idx.cap, idx.num_seqs)
    att, lb2 = res if res is not None else _attach_numpy(idx)
    return _group_border_nodes(idx, att, lb2)
