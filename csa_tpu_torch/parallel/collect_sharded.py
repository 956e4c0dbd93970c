"""The collect cascade's N-sized front over the ranks of a mesh
(counterpart of :mod:`csa_tpu.parallel.collect_sharded`).

Each rank takes its shard of the sorted boundaries and runs the
single-device front's pieces (``engine._threshold_chans``,
``_interval_bounds``, ``_coverage_chans``, ``_parents``) on it:

* the PSV/NSV threshold scans and the all-sequences coverage scans are
  rank-local multi-channel scans (:mod:`csa_tpu_torch.index.mscan`, the
  hand-written kernel on a CUDA rank, on the rank's stream), three calls
  a rank, as the single-device front batches them.  The carry across
  ranks comes from an all-gather of every rank's channel ends (their
  maxima, or minima) and is folded into the first element the scan
  visits: a running max started from max(x0, carry) is the running max
  with the carry, so the coverage scans keep their min over channels;
* the deep descent reads a range-min table built once a card over the
  gathered lcp;
* the canonical representative of an (start, end) group is the least
  original index among its members (what the single-device stable sort
  puts first).  The keys ``start * (N + 1) + end`` are sorted by
  :func:`.dsort.net_sort_pairs`, whose ties come in no stable order, so
  the gathered sorted pairs are reduced by segment minimum, once a card;
* the deepest-node marks scatter into the whole array once a card.

Every step gives the single-device front's values, so (collected, start,
end) are equal element for element.
"""

from __future__ import annotations

import torch

from ..index import engine, mscan
from . import dsort
from .sharded import Mesh, Ranks, relabel, unzip


def _gcummax(ranks: Ranks, chans: list, *, reduce: bool = False) -> list:
    """Inclusive running max along axis 1 of the (M, S) int32 channels of
    every rank, over the whole mesh; ``reduce`` returns each rank's (S,)
    min over its channels."""
    ends = ranks.all_gather(ranks.each(lambda r, c: c.amax(1)[None], chans))

    def scan(r, c, e):
        if r:
            c[:, 0] = torch.maximum(c[:, 0], e[:r].amax(0))
        return mscan.multi_cummax(c, min_over_channels=reduce)

    return ranks.each(scan, chans, ends)


def _gcummin_rev(ranks: Ranks, chans: list) -> list:
    """Inclusive running min from the right along axis 1 of every rank's
    (M, S) int32 channels, over the whole mesh."""
    D = ranks.size
    ends = ranks.all_gather(ranks.each(lambda r, c: c.amin(1)[None], chans))

    def scan(r, c, e):
        if r < D - 1:
            c[:, -1] = torch.minimum(c[:, -1], e[r + 1:].amin(0))
        return mscan.multi_cummin(c, reverse=True)

    return ranks.each(scan, chans, ends)


def _canonical(su, sb, N: int):
    """(N,) canonical representative of every boundary from the whole
    key-sorted (key, index) pairs: the least index of its key group."""
    head = torch.cat([su.new_ones(1, dtype=torch.bool), su[1:] != su[:-1]])
    seg = torch.cumsum(head.to(torch.int64), 0) - 1
    least = torch.full_like(sb, N).scatter_reduce_(0, seg, sb, "amin")
    canon = torch.empty_like(sb)
    canon[sb] = least[seg]
    return canon


def _marked(dest, N: int):
    """(N,) bool, True at every ``dest`` below N (N marks nothing)."""
    out = torch.zeros(N + 1, dtype=torch.bool, device=dest.device)
    out[dest] = True
    return out[:N]


def collect_front(mesh: Mesh, order, lcp, lengths, *, k: int, n_max: int,
                  tdeep: int, pack_w: int):
    """``engine._collect_front`` over the ranks of ``mesh`` (a power-of-two
    count dividing N): ``order``, ``lcp`` and ``lengths`` on the home
    rank's device in (the whole of them on every process), (collected,
    start, end) there out."""
    ranks = Ranks(relabel(mesh, "x"))
    D = ranks.size
    N = order.shape[0]
    S = N // D
    order_l = ranks.scatter(order)
    lcp_l = ranks.scatter(lcp)
    lens = ranks.replicate(lengths)
    gidx = ranks.each(lambda r, o: torch.arange(r * S, (r + 1) * S,
                                                device=o.device), order_l)

    fwd, bwd = unzip(ranks.each(
        lambda r, lc, g: engine._threshold_chans(lc, g, N, pack_w),
        lcp_l, gidx), 2)
    rs = _gcummax(ranks, fwd)
    ns = _gcummin_rev(ranks, bwd)
    lcp_full = ranks.all_gather(lcp_l)
    minv = ranks.per_device(
        lambda r, lf: tuple(engine._sparse_min(lf, tdeep)), lcp_full)
    start, end = unzip(ranks.each(
        lambda r, lc, g, a, b, mv: engine._interval_bounds(
            lc, g, a, b, mv, n_total=N, tdeep=tdeep, pack_w=pack_w),
        lcp_l, gidx, rs, ns, minv), 2)
    cover = _gcummax(ranks, ranks.each(
        lambda r, o, ln, g: engine._coverage_chans(o, ln, g, k=k,
                                                   n_max=n_max),
        order_l, lens, gidx), reduce=True)
    cover_full = ranks.all_gather(cover)

    # canonical representative per (start, end) group
    keys = ranks.each(
        lambda r, lc, s, e: (torch.where(lc >= 1, s, N) * (N + 1)
                             + torch.where(lc >= 1, e, N)),
        lcp_l, start, end)
    su, sb = dsort.net_sort_pairs(ranks, keys, gidx)
    canon = ranks.per_device(lambda r, u, b: _canonical(u, b, N),
                             ranks.all_gather(su), ranks.all_gather(sb))

    # deepest: mark parents of all-seq canonical nodes
    def marks(r, lc, s, e, cf, Lf, lf):
        has_node = lc >= 1
        allseq = has_node & (Lf[e] >= s)
        own = torch.arange(r * S, (r + 1) * S, device=lc.device)
        cand = has_node & (cf[r * S:(r + 1) * S] == own) & allseq
        parent_bound, parent_d = engine._parents(lf, s, e, N)
        has_parent = cand & (parent_d >= 1)
        pc = cf[torch.where(has_parent, parent_bound.clamp(max=N - 1), 0)]
        return cand, torch.where(has_parent, pc, N)

    cand, dest = unzip(ranks.each(marks, lcp_l, start, end, canon,
                                  cover_full, lcp_full), 2)
    haschild = ranks.per_device(lambda r, d: _marked(d, N),
                                ranks.all_gather(dest))
    collected = ranks.each(lambda r, c, h: c & ~h[r * S:(r + 1) * S],
                           cand, haschild)
    out = tuple(ranks.gather_to_first(x) for x in (collected, start, end))
    ranks.finish(*out)
    return out
