"""Shard-local prefix-doubling ladder: the index build over the ranks of
a mesh (counterpart of :mod:`csa_tpu.parallel.dsort_ladder`).

The rotations are cut into D equal shards of S = N / D in their flat
order ``g = seq * n_max + pos``, one a rank, and the single-device
build's stages (:func:`csa_tpu_torch.index.engine._device_build`) run
on them:

* level 0 and every refinement sort their (key, g) pairs with
  :func:`.dsort.net_sort_pairs` (a local sort and the merge-split
  network);
* the group statistics (rank starts, tied groups, the largest group)
  are local scans whose carries across ranks come from an all-gather of
  each rank's ends, and a ``psum`` / ``pmax``;
* the rank scatter ``rank[order] = start`` runs once a card on the
  gathered (order, start) pairs, which gives the card the whole rank
  array that the next level's doubling gather and the LCP descent read;
* the LCP descent and its packed tail run on each rank's adjacent pairs;
  the pair straddling two ranks takes the right neighbour's first
  entry, and the lcp shifts one place right across a rank boundary (a
  left halo).

Ranks are group starts, which do not depend on the order of tied keys,
and the last level's keys are unique, so ``order`` and ``lcp`` equal
the single-device build's element for element.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..index import engine
from ..utils import PROFILER, sync
from . import dsort
from .sharded import Mesh, Ranks, relabel, unzip


def _sync(ranks: Ranks) -> None:
    """End a timed stage when every rank's work ends (profiling only)."""
    for dev in ranks.lead:
        sync(dev)


def _stats_and_rank(ranks: Ranks, su: list, sg: list, *, S: int, N: int):
    """Group statistics of the globally sorted (key, g) shards and the
    rank rebuild, as the single-device ``engine._group_stats``:
    ``(rank, num_tied, max_group)`` with ``rank`` the whole (N,)
    group-start rank array a card (shared by its ranks), ``num_tied`` a
    host int (the same on every process) and ``max_group`` a scalar a
    rank."""
    D = ranks.size
    left = ranks.ppermute(ranks.each(lambda r, u: u[-1:], su),
                          [(i, i + 1) for i in range(D - 1)])

    def local(r, u, lft):
        first = (u.new_ones(1, dtype=torch.bool) if lft is None
                 else u[:1] != lft)
        newgrp = torch.cat([first, u[1:] != u[:-1]])
        gidx = torch.arange(r * S, (r + 1) * S, device=u.device)
        x = torch.where(newgrp, gidx, 0)
        a = torch.where(newgrp, gidx, N)
        return x, a, torch.stack([x.max(), a.min()])[None]

    x, a, ends = unzip(ranks.each(local, su, left), 3)
    ends = ranks.all_gather(ends)                # (D, 2) a card

    def scan(r, x, a, e):
        # the carries: the last group start before this rank and the
        # first one after it, folded into the scans' first elements
        if r:
            x[0] = torch.maximum(x[0], e[:r, 0].max())
        right = e[r + 1:, 1].min() if r < D - 1 else a.new_full((), N)
        a[-1] = torch.minimum(a[-1], right)
        start = torch.cummax(x, 0).values
        nxt = torch.cat([torch.cummin(a.flip(0), 0).values.flip(0)[1:],
                         right[None]])
        size = nxt - start
        return start, (size > 1).sum(), size.max()

    start, tied, big = unzip(ranks.each(scan, x, a, ends), 3)
    num_tied = ranks.item(ranks.psum(tied))

    def scatter(r, g, st):
        rank = torch.empty_like(st)
        rank[g] = st
        return rank

    rank = ranks.per_device(scatter, ranks.all_gather(sg),
                            ranks.all_gather(start))
    return rank, num_tied, ranks.pmax(big)


def device_build_dsort(encoded: Sequence[np.ndarray], mesh: Mesh, *,
                       pack_w: int = 12):
    """The index build over the ranks of ``mesh`` (a power-of-two count):
    the return contract of ``engine._device_build``,
    ``((order, lcp, lengths), (k, n_max, max_group0))`` with the tensors
    on the home rank's device (every process's first), or ``(None,
    None)`` when a sequence has duplicate rotations.  ``n_max`` is
    rounded up to a multiple of the rank count.  Every host value that
    steers the build (the tied count, the largest group, the duplicate
    check) is the same on every process, so each takes the same
    branches and issues the same exchanges."""
    fmesh = relabel(mesh, "x")
    D = fmesh.size
    dsort._merge_split_net(D)      # a power of two, or it raises
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    n_max = -(-engine._bucket(int(sizes.max())) // D) * D
    N = k * n_max
    S = N // D
    codes = np.zeros((k, n_max), dtype=np.int8)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e

    with PROFILER.phase("idx.pack"):
        # once a card, on the caller's stream, which the ranks' wait on
        packed, lengths = {}, {}
        for dev in dict.fromkeys(fmesh.devices[r] for r in fmesh.local):
            lengths[dev] = torch.from_numpy(sizes).to(dev)
            packed[dev] = engine._pack_keys(
                torch.from_numpy(codes).to(dev).to(torch.int64),
                lengths[dev], n_max=n_max, pack_w=pack_w)
            sync(dev)
    ranks = Ranks(fmesh)
    dev_of = fmesh.devices
    dev0 = fmesh.home
    gidx = ranks.each(lambda r, d: torch.arange(r * S, (r + 1) * S,
                                                device=d), dev_of)

    def geometry(g, d):
        base = (g // n_max) * n_max
        return base, g - base, lengths[d].clamp(min=1)[g // n_max]

    def level0(r, g, d):
        _, pos, n_of = geometry(g, d)
        # a padded slot's key lies above every packed key, and is unique
        return torch.where(pos < n_of, packed[d][r * S:(r + 1) * S],
                           engine._ALPHA ** pack_w + g)

    with PROFILER.phase("idx.l0_sort"):
        su, sg = dsort.net_sort_pairs(ranks, ranks.each(level0, gidx, dev_of),
                                      gidx)
        rank, nt, mg0 = _stats_and_rank(ranks, su, sg, S=S, N=N)
        mg0 = ranks.item(mg0)
        _sync(ranks)
    levels = [rank]
    N2 = 1 << (max(N, 2) - 1).bit_length()
    t = 0
    with PROFILER.phase("idx.refine"):
        while nt > 0 and (pack_w << t) < n_max:
            h = pack_w << t

            def refine(r, g, d, rk):
                base, pos, n_of = geometry(g, d)
                return rk[r * S:(r + 1) * S] * N2 + rk[base + (pos + h) % n_of]

            su, sg = dsort.net_sort_pairs(
                ranks, ranks.each(refine, gidx, dev_of, rank), gidx)
            rank, nt, _ = _stats_and_rank(ranks, su, sg, S=S, N=N)
            levels.append(rank)
            t += 1
        _sync(ranks)
    if nt > 0:
        # the whole order and rank on every process, so every process
        # finds the same answer
        order = ranks.gather_to_first(sg)
        with ranks.on(ranks.home):
            dup = engine._dup_check(order, rank[ranks.home], lengths[dev0],
                                    n_max=n_max)
        if dup:
            ranks.finish()
            return None, None

    with PROFILER.phase("idx.lcp"):
        # adjacent sorted pairs (a, b); the last rank's last one is a
        # dummy, which the shift below drops
        right = ranks.ppermute(ranks.each(lambda r, o: o[:1], sg),
                               [(i + 1, i) for i in range(D - 1)])

        def prep(r, a, rf, d):
            b = torch.cat([a[1:], a[:1] if rf is None else rf])
            n_of = lengths[d].clamp(min=1)
            return a, b, n_of[a // n_max], n_of[b // n_max]

        pairs = ranks.each(prep, sg, right, dev_of)
        off = ranks.each(lambda r, p: torch.zeros_like(p[0]), pairs)
        for tt in range(len(levels) - 1, -1, -1):
            off = ranks.each(
                lambda r, o, p, rk: engine._lcp_step(
                    o, rk, *p, pack_w << tt, n_max=n_max),
                off, pairs, levels[tt])

        lcp_pair = ranks.each(
            lambda r, o, p, d: engine._pair_lcp(
                o, packed[d], *p, n_max=n_max, pack_w=pack_w)[1],
            off, pairs, dev_of)
        left = ranks.ppermute(ranks.each(lambda r, lp: lp[-1:], lcp_pair),
                              [(i, i + 1) for i in range(D - 1)])
        lcp = ranks.each(
            lambda r, lp, lft: torch.cat(
                [lp.new_zeros(1) if lft is None else lft, lp[:-1]]),
            lcp_pair, left)
        _sync(ranks)

    with PROFILER.phase("idx.replicate"):
        order = ranks.gather_to_first(sg)
        lcp = ranks.gather_to_first(lcp)
        ranks.finish(order, lcp)
        _sync(ranks)
    return (order, lcp, lengths[dev0]), (k, n_max, mg0)

