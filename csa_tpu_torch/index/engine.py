"""Cyclic suffix-array engine on torch tensors (counterpart of the
single-device paths of :mod:`csa_tpu.index.engine`: the staged one and
the single-dispatch programs, replayed as CUDA graphs).

The algorithm is the JAX package's, stage for stage, with the same padded
layout: sequences are padded to ``n_max = _bucket(max len)`` and a
rotation is the flat index ``g = seq * n_max + pos``, so ``order`` and
``lcp`` agree element for element with ``csa_tpu.index.engine``.

* packed base-5 keys of the first ``pack_w`` cyclic characters;
* prefix doubling with group-start ranks, ended as soon as every group
  is a singleton (the host reads one scalar per level);
* adjacent-pair LCP by binary descent over the stored rank levels, then a
  digit-by-digit tail inside the packed window;
* the collect cascade: PSV/NSV (``pack_w`` threshold scans each way plus a
  bounded deep descent), all-sequences coverage (k last-occurrence scans
  reduced by a min), canonical representatives, deepest-node marking;
  the three multi-channel scans go through :mod:`.mscan`, i.e. the
  hand-written kernel on a CUDA device;
* the tail: suffix-containment filter by occurrence-end join, uniqueness
  and positions, returned as the slim final-block view.

Every other operation is a plain torch op.  XLA needs static shapes, so
the JAX package pads its block tables to ``cap``/``ecap``/``fcap`` and
retries on overflow; the staged route here sizes them from the data,
and the fused route (one CUDA graph a call, :mod:`.graphs`) pads and
retries as JAX does; the outputs are identical.  JAX clamps
out-of-range gathers and drops out-of-range scatters while torch raises;
every index below is in range by construction (the comments say why
where it is not obvious).

Two-key stable sorts become one stable ``torch.sort`` of an int64 key
packing both int32 keys (the first key in the high part), which orders
exactly like ``jax.lax.sort(..., num_keys=2, is_stable=True)``.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import PROFILER, sync
from . import graphs, mscan

_ALPHA = 5  # alphabet (ACGT-)


def _bucket(n: int, quantum: int = 1024) -> int:
    return ((n + quantum - 1) // quantum) * quantum


def _num_levels(n_max: int, pack_w: int) -> int:
    """Packed cyclic rank levels: pack_w << (levels - 1) >= n_max."""
    t = 1
    while (pack_w << (t - 1)) < n_max:
        t += 1
    return t


def _linear_levels(total: int) -> int:
    """Level count for the linear suffix sort (plain 1 << t windows)."""
    t = 1
    while (1 << (t - 1)) < total:
        t += 1
    return t


def _pow2_at_least(x: int, floor: int = 1) -> int:
    v = max(int(x), floor)
    return 1 << (v - 1).bit_length()


def _tdeep_for(mg0: int, k: int, n_max: int) -> int:
    """Deep-descent level count: 2**tdeep >= max level-0 group size."""
    return min(
        _pow2_at_least(mg0, 16).bit_length() - 1,
        int(np.ceil(np.log2(max(k * n_max, 2)))) + 1,
    )


def _read(fn, *args):
    """``fn(*args)``, which waits for the device and brings a value of
    it to the host: each call counts one in the counter
    ``idx.device_reads`` (the block stage's reads: the staged route's,
    or the fused route's one download a program run)."""
    PROFILER.add("idx.device_reads", 1)
    return fn(*args)


def _stable_sort2(k1: torch.Tensor, k2: torch.Tensor, span: int):
    """Stable lexicographic order of (k1, k2), 0 <= k2 < span."""
    _, order = torch.sort(k1 * span + k2, stable=True)
    return order


def _n_of_flat(lengths: torch.Tensor, n_max: int) -> torch.Tensor:
    """(N,) per-rotation sequence length (>= 1)."""
    return lengths.clamp(min=1)[:, None].expand(-1, n_max).reshape(-1)


def _pack_keys(codes: torch.Tensor, lengths: torch.Tensor, *, n_max: int,
               pack_w: int) -> torch.Tensor:
    """Base-5 key of the pack_w-char cyclic window at every position:
    rolls for the bulk, then the <= pack_w-1 wrap slots per sequence
    recomputed exactly."""
    k = codes.shape[0]
    dev = codes.device
    acc = torch.zeros_like(codes)
    for t in range(pack_w):
        acc = acc * _ALPHA + (torch.roll(codes, -t, dims=1) if t else codes)
    packed = acc.reshape(-1).clone()
    n_s = lengths.clamp(min=1)[:, None]
    j = torch.arange(pack_w - 1, device=dev)[None, :]
    p = (n_s - (pack_w - 1) + j) % n_s
    srow = torch.arange(k, device=dev)[:, None] * n_max
    cflat = codes.reshape(-1)
    key = torch.zeros_like(p)
    for t in range(pack_w):
        key = key * _ALPHA + cflat[srow + (p + t) % n_s]
    # duplicate slots (sequences shorter than pack_w - 1) get equal keys
    packed[(srow + p).reshape(-1)] = key.reshape(-1)
    return packed


def _group_stats(newgrp: torch.Tensor, g: torch.Tensor):
    """Group start per sorted slot, tied-group count and max group size,
    the counts as device scalars (no host read).  A cumsum and a table
    of group starts, not two one-row running max/min scans: a slot's
    group start, and the next group's start or ``n``."""
    n = newgrp.shape[0]
    gid = torch.cumsum(newgrp, 0) - 1
    # first[j]: start of group j; first[#groups] stays n; n + 1 is a dump
    first = g.new_full((n + 2,), n)
    first.scatter_(0, torch.where(newgrp, gid, n + 1), g)
    start_idx = first[gid]
    size = first[gid + 1] - start_idx
    return start_idx, (size > 1).sum(), size.max()


def _level0(packed, lengths, *, n_max: int, pack_w: int):
    """Initial sort by packed key; group-start ranks; tie stats."""
    n_total = packed.shape[0]
    g = torch.arange(n_total, device=packed.device)
    valid = (g % n_max) < _n_of_flat(lengths, n_max)
    key = torch.where(valid, packed, _ALPHA ** pack_w + g)
    ks, order = torch.sort(key, stable=True)
    newgrp = torch.cat([ks.new_ones(1, dtype=torch.bool), ks[1:] != ks[:-1]])
    start_idx, num_tied, max_group = _group_stats(newgrp, g)
    rank = torch.empty_like(start_idx)
    rank[order] = start_idx
    return order, rank, num_tied, max_group


def _refine(rank, lengths, h: int, *, n_max: int):
    """One prefix-doubling level: rank2 gather + 2-key sort + group-start
    rank rebuild.  Ranks are group starts in [0, N)."""
    n_total = rank.shape[0]
    g = torch.arange(n_total, device=rank.device)
    base = (g // n_max) * n_max
    r2 = rank[base + (g - base + h) % _n_of_flat(lengths, n_max)]
    order = _stable_sort2(rank, r2, n_total)
    r1s, r2s = rank[order], r2[order]
    newgrp = torch.cat([r1s.new_ones(1, dtype=torch.bool),
                        (r1s[1:] != r1s[:-1]) | (r2s[1:] != r2s[:-1])])
    start_idx, num_tied, max_group = _group_stats(newgrp, g)
    rank_new = torch.empty_like(start_idx)
    rank_new[order] = start_idx
    return order, rank_new, num_tied, max_group


def _dup_flag(order, rank, lengths, *, n_max: int) -> torch.Tensor:
    """Same-sequence identical periodic rotations, as a device bool."""
    rs = rank[order]
    seq_s = order // n_max
    valid_s = (order % n_max) < _n_of_flat(lengths, n_max)[order]
    return ((rs[1:] == rs[:-1]) & (seq_s[1:] == seq_s[:-1])
            & valid_s[1:]).any()


def _dup_check(order, rank, lengths, *, n_max: int) -> bool:
    """Same-sequence identical periodic rotations."""
    return _read(bool, _dup_flag(order, rank, lengths, n_max=n_max))


def _lcp_step(off, rank_t, a, b, n_a, n_b, h: int, *, n_max: int):
    """One binary-descent level of the adjacent-pair LCP."""
    base_a = (a // n_max) * n_max
    base_b = (b // n_max) * n_max
    ga = base_a + (a - base_a + off) % n_a
    gb = base_b + (b - base_b + off) % n_b
    return torch.where(rank_t[ga] == rank_t[gb], off + h, off)


def _pair_lcp(off, packed, a, b, n_a, n_b, *, n_max: int, pack_w: int):
    """Raw and capped LCP of adjacent sorted rotations ``a``, ``b`` (flat
    ids, lengths ``n_a``, ``n_b``) from the binary descent's offset: the
    sub-pack_w tail compares the two differing packed windows digit by
    digit; a pair with a padded slot gets 0."""
    base_a = (a // n_max) * n_max
    base_b = (b // n_max) * n_max
    ka = packed[base_a + (a - base_a + off) % n_a]
    kb = packed[base_b + (b - base_b + off) % n_b]
    still = torch.ones_like(off, dtype=torch.bool)
    run = torch.zeros_like(off)
    for i in range(pack_w):
        sh = _ALPHA ** (pack_w - 1 - i)
        still = still & ((ka // sh) % _ALPHA == (kb // sh) % _ALPHA)
        run = run + still.to(run.dtype)
    valid = ((a % n_max) < n_a) & ((b % n_max) < n_b)
    raw_pair = torch.where(valid, off + run, 0)
    return raw_pair, torch.minimum(raw_pair, torch.minimum(n_a, n_b))


def _lcp_tail(off, packed, order, lengths, *, n_max: int, pack_w: int):
    """The (N,) raw and capped lcp (index i = boundary sa[i-1]/sa[i])."""
    n_sorted = _n_of_flat(lengths, n_max)[order]
    raw_pair, lcp_pair = _pair_lcp(off, packed, order[:-1], order[1:],
                                   n_sorted[:-1], n_sorted[1:], n_max=n_max,
                                   pack_w=pack_w)
    zero = off.new_zeros(1)
    return torch.cat([zero, raw_pair]), torch.cat([zero, lcp_pair])


def _device_build(encoded: Sequence[np.ndarray], device, *, pack_w: int = 12):
    """Pack + level-0 sort + early-terminated refinement + LCP.

    Returns ``((order, lcp, lengths), (k, n_max, max_group0))`` with
    tensors on ``device``, or ``(None, None)`` when a sequence has
    duplicate rotations (periodic input)."""
    arrays, aux, _levels = _device_build_levels(encoded, device,
                                                pack_w=pack_w)
    return arrays, aux


def _device_build_levels(encoded: Sequence[np.ndarray], device, *,
                         pack_w: int = 12):
    """:func:`_device_build`'s result and the number of refinement
    levels it ran."""
    device = torch.device(device)
    k = len(encoded)
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    n_max = _bucket(int(sizes.max()))
    codes = np.zeros((k, n_max), dtype=np.int8)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e
    codes_t = torch.from_numpy(codes).to(device).to(torch.int64)
    lengths = torch.from_numpy(sizes).to(device)

    with PROFILER.phase("idx.pack"):
        packed = _pack_keys(codes_t, lengths, n_max=n_max, pack_w=pack_w)
        sync(device)
    with PROFILER.phase("idx.l0_sort"):
        order, rank, nt, mg0 = _level0(packed, lengths, n_max=n_max,
                                       pack_w=pack_w)
        nt, mg0 = _read(int, nt), _read(int, mg0)
    ranks = [rank]
    t = 0
    with PROFILER.phase("idx.refine"):
        while nt > 0 and (pack_w << t) < n_max:
            order, rank, nt, _ = _refine(rank, lengths, pack_w << t,
                                         n_max=n_max)
            nt = _read(int, nt)
            ranks.append(rank)
            t += 1
    if nt > 0 and _dup_check(order, rank, lengths, n_max=n_max):
        return None, None, t

    with PROFILER.phase("idx.lcp"):
        a, b = order[:-1], order[1:]
        n_of = _n_of_flat(lengths, n_max)
        n_a, n_b = n_of[a], n_of[b]
        off = torch.zeros_like(a)
        for tt in range(len(ranks) - 1, -1, -1):
            off = _lcp_step(off, ranks[tt], a, b, n_a, n_b, pack_w << tt,
                            n_max=n_max)
        _raw, lcp = _lcp_tail(off, packed, order, lengths, n_max=n_max,
                              pack_w=pack_w)
        sync(device)
    return (order, lcp, lengths), (k, n_max, mg0), t


def _threshold_chans(lcp, idx, n_total: int, pack_w: int):
    """The PSV and NSV threshold scans' (pack_w, n) int32 inputs: channel
    v - 1 holds a boundary's position where its lcp is below v, else -1
    (forward) or n_total (backward)."""
    vv = torch.arange(1, pack_w + 1, device=lcp.device)[:, None]
    below = lcp[None, :] < vv
    idx32 = idx.to(torch.int32)
    return (torch.where(below, idx32, -1),
            torch.where(below, idx32, n_total))


def _sparse_min(lcp, tdeep: int):
    """Levels of the range-min table of the deep descent over the whole
    lcp: level t holds the min of 2**t boundaries from each position."""
    n_total = lcp.shape[0]
    minv = [lcp]
    for t in range(tdeep - 1):
        half = min(1 << t, n_total)
        prev = minv[-1]
        shifted = torch.cat([prev[half:], prev.new_full((half,), 2**30)])
        minv.append(torch.minimum(prev, shifted))
    return minv


def _interval_bounds(lcp, idx, rs_all, ns_all, minv, *, n_total: int,
                     tdeep: int, pack_w: int):
    """(start, end) of the lcp-interval of each boundary at positions
    ``idx`` (with ``lcp`` there): PSV/NSV from the inclusive threshold
    scans ``rs_all``/``ns_all`` for lcp in [1, pack_w] (a boundary is
    never "below" itself, so they are exactly psv/nsv), and a binary
    descent over the range-min table ``minv`` of the whole lcp, bounded
    by the level-0 group size, for deeper ones."""
    psv = torch.full_like(idx, -1)
    nsv = torch.full_like(idx, n_total)
    for v in range(1, pack_w + 1):
        sel = lcp == v
        psv = torch.where(sel, rs_all[v - 1], psv)
        nsv = torch.where(sel, ns_all[v - 1], nsv)
    deep = lcp > pack_w
    if tdeep > 0:
        ln = torch.zeros_like(idx)
        for t in range(tdeep - 1, -1, -1):
            j = idx - ln - (1 << t)
            mv = minv[t][j.clamp(min=0)]
            grow = (j >= 0) & (mv >= lcp) & deep
            ln = torch.where(grow, ln + (1 << t), ln)
        rn = torch.zeros_like(idx)
        for t in range(tdeep - 1, -1, -1):
            j = idx + rn + 1
            ok = (j + (1 << t) - 1) <= n_total - 1
            mv = minv[t][j.clamp(max=n_total - 1)]
            grow = ok & (mv >= lcp) & deep
            rn = torch.where(grow, rn + (1 << t), rn)
        psv = torch.where(deep, idx - ln - 1, psv)
        nsv = torch.where(deep, idx + rn + 1, nsv)
    # nsv in [i+1, N], so end in [0, N-1]
    return psv.clamp(min=0), nsv - 1


def _coverage_chans(order, lengths, idx, *, k: int, n_max: int):
    """The all-sequences coverage scans' (k, n) int32 inputs: channel s
    holds the positions of sequence s's real rotations, else -1."""
    valid_s = (order % n_max) < lengths.clamp(min=1)[order // n_max]
    sv_ch = torch.arange(k, device=order.device)[:, None]
    return torch.where(
        ((order // n_max)[None, :] == sv_ch) & valid_s[None, :],
        idx.to(torch.int32)[None, :], -1)


def _parents(lcp, start, end, n_total: int):
    """Bound and depth of each interval's parent: the deeper of the two
    boundaries beside it in the whole ``lcp`` (past the end counts 0)."""
    left_d = lcp[start]
    nxt = end + 1
    right_d = torch.where(nxt < n_total, lcp[nxt.clamp(max=n_total - 1)], 0)
    return (torch.where(left_d >= right_d, start, nxt),
            torch.maximum(left_d, right_d))


def _collect_front(order, lcp, lengths, *, k: int, n_max: int, tdeep: int,
                   pack_w: int):
    """PSV/NSV intervals, all-sequences coverage, canonical
    representatives and deepest-node marking.  Returns (collected, start,
    end) over the N sorted boundaries."""
    n_total = order.shape[0]
    dev = order.device
    idx = torch.arange(n_total, device=dev)

    # the threshold scans, both directions, and the k coverage scans with
    # the min over sequences: three multi-channel scans
    fwd, bwd = _threshold_chans(lcp, idx, n_total, pack_w)
    start, end = _interval_bounds(
        lcp, idx, mscan.multi_cummax(fwd),
        mscan.multi_cummin(bwd, reverse=True), _sparse_min(lcp, tdeep),
        n_total=n_total, tdeep=tdeep, pack_w=pack_w)
    has_node = lcp >= 1
    L = mscan.multi_cummax(_coverage_chans(order, lengths, idx, k=k,
                                           n_max=n_max),
                           min_over_channels=True)
    allseq = has_node & (L[end] >= start)

    # canonical representative per (start, end) group
    s_key = torch.where(has_node, start, n_total)
    e_key = torch.where(has_node, end, n_total)
    bidx = _stable_sort2(s_key, e_key, n_total + 1)
    sk, ek = s_key[bidx], e_key[bidx]
    head = torch.cat([sk.new_ones(1, dtype=torch.bool),
                      (sk[1:] != sk[:-1]) | (ek[1:] != ek[:-1])])
    seg_id = torch.cumsum(head.to(torch.int64), 0) - 1
    # the scatters write the unselected slots to a dump slot past N, so
    # no shape depends on the data (the fused program runs this front)
    canon_of_seg = torch.zeros(n_total + 1, dtype=idx.dtype, device=dev)
    canon_of_seg.scatter_(0, torch.where(head, seg_id, n_total), bidx)
    canon_arr = torch.empty_like(idx)
    canon_arr[bidx] = canon_of_seg[seg_id]
    is_canon = has_node & (canon_arr == idx)

    # deepest: mark parents of all-seq canonical nodes
    parent_bound, parent_d = _parents(lcp, start, end, n_total)
    has_parent = is_canon & allseq & (parent_d >= 1)
    pb = torch.where(has_parent, parent_bound.clamp(max=n_total - 1), 0)
    haschild = torch.zeros(n_total + 1, dtype=torch.bool, device=dev)
    haschild.scatter_(0, torch.where(has_parent, canon_arr[pb], n_total),
                      has_parent)
    collected = is_canon & allseq & ~haschild[:n_total]
    return collected, start, end


class RotationFinal:
    """Slim pipeline view: the suffix-free unique blocks plus the cascade
    counts (field-compatible with ``csa_tpu.index.engine.RotationFinal``)."""

    __slots__ = (
        "num_collected", "num_after_suffix", "final_start", "final_depth",
        "final_positions",
    )


def _collect_tail(order, lcp, lengths, collected, start, end, *, k: int,
                  n_max: int):
    """Compaction, interval expansion, suffix join, uniqueness and
    positions.  Returns (nb, total_e, n_suffix, fstart, fdepth,
    fpositions), ``total_e`` the expanded interval members, with the
    final-block fields as host arrays."""
    n_total = order.shape[0]
    dev = order.device
    n_of = _n_of_flat(lengths, n_max)
    pos_sorted = order % n_max

    bsel = _read(torch.nonzero, collected).reshape(-1)
    nb = int(bsel.shape[0])
    bstart, bend, bdepth = start[bsel], end[bsel], lcp[bsel]
    width = bend - bstart + 1          # >= 2: a node boundary lies inside

    # expand the (disjoint) collected intervals: one entry per member
    blk = _read(torch.repeat_interleave, torch.arange(nb, device=dev),
                width)
    offs = torch.cumsum(width, 0) - width
    r = bstart[blk] + (torch.arange(blk.shape[0], device=dev) - offs[blk])
    gmem = order[r]
    mseq = gmem // n_max
    d_b = bdepth[blk]
    end_rot = mseq * n_max + (gmem % n_max + d_b) % n_of[gmem]

    # suffix filter: occurrence-end join
    repg = order[bstart]
    rbase = (repg // n_max) * n_max
    rep_end = rbase + (repg - rbase + bdepth) % n_of[repg]
    maxd = torch.full((n_total,), -1, dtype=lcp.dtype, device=dev)
    maxd.scatter_reduce_(0, rep_end, bdepth, reduce="amax")
    hit = maxd[end_rot] > d_b
    removed = torch.zeros(nb, dtype=torch.bool, device=dev)
    removed[blk[hit]] = True
    keep_suffix = ~removed

    # uniqueness + positions
    unique = width == k
    minr = torch.full((nb * k,), 2**30, dtype=r.dtype, device=dev)
    minr.scatter_reduce_(0, blk * k + mseq, r, reduce="amin")
    positions = torch.where(minr < 2**30,
                            pos_sorted[minr.clamp(max=n_total - 1)], 0)

    final = keep_suffix & unique
    fsel = _read(torch.nonzero, final).reshape(-1)
    fstart = _read(torch.Tensor.cpu, bstart[fsel]).numpy()
    fdepth = _read(torch.Tensor.cpu, bdepth[fsel]).numpy()
    fpos = _read(torch.Tensor.cpu, positions.reshape(nb, k)[fsel]).numpy()
    return (nb, int(blk.shape[0]), _read(int, keep_suffix.sum()), fstart,
            fdepth, fpos)


def _slim(nb: int, n_suffix: int, start, depth, pos) -> RotationFinal:
    """RotationFinal in the numpy engine's block order (as
    ``csa_tpu.index.engine._parse_slim``)."""
    out = RotationFinal()
    out.num_collected = nb
    out.num_after_suffix = n_suffix
    start = np.asarray(start, dtype=np.int64)
    depth = np.asarray(depth, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)  # (n_final, k)
    o = np.lexsort((-depth, start))
    out.final_start = start[o]
    out.final_depth = depth[o]
    out.final_positions = pos[o]
    return out


# The fused route: the whole block stage as ONE program of static shapes
# (csa_tpu.index.engine._fused_small_program), run on a CUDA device as
# one replay of a CUDA graph (.graphs) with one download.  The program
# makes no host read, so the level loop is unrolled to a cached guess
# ``levels`` of the refinement count (JAX runs an on-device while_loop):
# a refinement of all-unique group-start ranks gives back the same rank,
# so a guess at or above the count the data needs gives JAX's output
# exactly, and the program returns the tie count for the host to retry a
# guess that was too small.  Every shape that JAX pads to a cap is
# padded the same way and validated the same way.

# padded size k * _bucket(max len) up to which rotation_final replays
# the fused block stage on a key this process has already run: the warm
# crossover that chip_smoke.py's phase `fused` measured on an NVIDIA H100
# 80GB HBM3 at 700 W (PERF.md section 6): a replay beat the staged call
# up to 8 x 200 kbp (1,605,632 padded) and lost at 8 x 500 kbp (55.78
# against 43.23 ms).  A key's first call stays staged: a capture costs
# more than the staged call at every size measured (Primates 746-1,053
# against 501-518 ms in a fresh process).
REPLAY_MAX_CHARS = 1_605_632

# padded size up to which linear_suffix_order takes the fused route.
# The default, 0, turns it off: in the same measurements its first call
# was slower fused (a capture) than staged at every size, and a warm
# replay lost to the staged loop at 8 x 500 kbp (80.50 against 68.53 ms).
# CSA_TPU_FUSED_MAX_CHARS overrides it, read at import as csa_tpu reads it
FUSED_MAX_CHARS = int(os.environ.get("CSA_TPU_FUSED_MAX_CHARS", 0))

# the host loop's first guesses (csa_tpu's: tdeep 7, fcap 1024, ecap
# 1 << 14; refinement counts from the fixtures: 3-7 cyclic, 6-10 linear)
TDEEP_START = 7
FCAP_MIN = 1024
ECAP_MIN = 1 << 14
LEVELS_START = 6
LINEAR_LEVELS_START = 10
LEVELS_STEP = 2

# (k, n_max) -> last good guess, as csa_tpu's caches
_TDEEP_CACHE: dict = {}
_CAPS_CACHE: dict = {}   # (cap, ecap, fcap)
_LEVELS_CACHE: dict = {}
_LINEAR_LEVELS_CACHE: dict = {}  # total -> refinements


def _first_true(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the first ``size`` set entries of ``mask``, the rest 0
    (``jnp.nonzero(mask, size=size, fill_value=0)``)."""
    pos = torch.cumsum(mask, 0) - 1
    out = pos.new_zeros(size + 1)
    out.scatter_(0, torch.where(mask & (pos < size), pos, size),
                 torch.arange(mask.shape[0], device=mask.device))
    return out[:size]


def _collect_tail_capped(order, lcp, lengths, collected, start, end, *,
                         k: int, n_max: int, cap: int, ecap: int,
                         fcap: int) -> torch.Tensor:
    """Twin of csa_tpu's ``_collect_tail`` with its static caps: blocks
    padded to ``cap``, interval members to ``ecap``, final blocks to
    ``fcap``; gathers clamped and scatters of unused slots sent to a
    slot past the end, as JAX clamps and drops.  Returns the slim packed
    vector ``[nb, total_e, n_suffix, n_final, fstart(fcap),
    fdepth(fcap), fpos(fcap * k)]``; a count above its cap tells the
    host to retry larger."""
    n_total = k * n_max
    dev = order.device
    n_of = _n_of_flat(lengths, n_max)
    pos_sorted = order % n_max

    # compact to cap blocks
    nb = collected.sum()
    bsel = _first_true(collected, cap)
    bi = torch.arange(cap, device=dev)
    validb = bi < nb
    bstart = torch.where(validb, start[bsel], 0)
    bend = torch.where(validb, end[bsel], -1)
    bdepth = torch.where(validb, lcp[bsel], 0)
    width = torch.where(validb, bend - bstart + 1, 0)
    offs = torch.cat([width.new_zeros(1), torch.cumsum(width, 0)])
    total_e = offs[cap]

    # expand the (disjoint) collected intervals to ecap members.  JAX
    # scatters each live block's id to its first member (clamped to
    # ecap - 1) and takes a running max; the starts grow with the block
    # id, so that max is the c-th live block, c the live blocks starting
    # at or before the member: a count and a cumsum, not a one-row scan
    e_idx = torch.arange(ecap, device=dev)
    live = validb & (width > 0)
    seen = torch.zeros(ecap, dtype=torch.int64, device=dev).scatter_add_(
        0, torch.where(live, offs[:cap].clamp(max=ecap - 1), ecap - 1),
        live.to(torch.int64)).cumsum(0)
    blk = torch.where(seen > 0,
                      _first_true(live, cap)[(seen - 1).clamp(min=0)], 0)
    active = e_idx < total_e.clamp(max=ecap)
    r = torch.where(active, bstart[blk] + (e_idx - offs[blk]), 0)
    gmem = order[r]
    mseq = gmem // n_max
    d_b = bdepth[blk]
    end_rot = mseq * n_max + (gmem % n_max + d_b) % n_of[gmem]

    # suffix filter: occurrence-end join
    repg = order[bstart.clamp(max=n_total - 1)]
    rbase = (repg // n_max) * n_max
    rep_end = rbase + (repg - rbase + bdepth) % n_of[repg]
    maxd = torch.full((n_total + 1,), -1, dtype=torch.int64, device=dev)
    maxd.scatter_reduce_(0, torch.where(validb, rep_end, n_total),
                         torch.where(validb, bdepth, -1), reduce="amax")
    hit = active & (maxd[end_rot.clamp(max=n_total - 1)] > d_b)
    removed = torch.zeros(cap, dtype=torch.int64, device=dev)
    removed.scatter_reduce_(0, torch.where(active, blk, cap - 1),
                            hit.to(torch.int64), reduce="amax")
    keep_suffix = validb & (removed == 0)

    # uniqueness + positions
    unique = validb & (width == k)
    big = 2**30
    minr = torch.full((cap * k,), big, dtype=torch.int64, device=dev)
    minr.scatter_reduce_(0, torch.where(active, blk * k + mseq, 0),
                         torch.where(active, r, big), reduce="amin")
    positions = torch.where(minr < big,
                            pos_sorted[minr.clamp(max=n_total - 1)], 0)

    n_suffix = keep_suffix.sum()
    final = keep_suffix & unique
    n_final = final.sum()
    fsel = _first_true(final, fcap)
    fvalid = torch.arange(fcap, device=dev) < n_final
    fstart = torch.where(fvalid, bstart[fsel], 0)
    fdepth = torch.where(fvalid, bdepth[fsel], 0)
    fpos = torch.where(fvalid[:, None], positions.reshape(cap, k)[fsel], 0)
    return torch.cat([torch.stack([nb, total_e, n_suffix, n_final]),
                      fstart, fdepth, fpos.reshape(-1)])


def _fused_block_program(codes, lengths, *, k: int, n_max: int,
                         pack_w: int, levels: int, tdeep: int, cap: int,
                         ecap: int, fcap: int) -> torch.Tensor:
    """The rotation block stage with static shapes (twin of csa_tpu's
    ``_fused_small_program``): pack, level 0, ``levels`` refinements,
    the duplicate flag, the LCP descent over all ``_num_levels + 1``
    rank rows (rows past the last refinement hold the final rank), the
    collect front and the capped tail.  ``codes`` (k, n_max) and
    ``lengths`` (k,) are integer tensors.  Returns one int32 vector:
    csa_tpu's ``[dup, mg0, nb, total_e, n_suffix, n_final, fstart(fcap),
    fdepth(fcap), fpos(fcap * k)]`` followed by the tie count after the
    last refinement."""
    codes = codes.to(torch.int64)
    lengths = lengths.to(torch.int64)
    lmax = _num_levels(n_max, pack_w)
    packed = _pack_keys(codes, lengths, n_max=n_max, pack_w=pack_w)
    order, rank, nt, mg0 = _level0(packed, lengths, n_max=n_max,
                                   pack_w=pack_w)
    ranks = [rank]
    for t in range(levels):
        order, rank, nt, _ = _refine(rank, lengths, pack_w << t, n_max=n_max)
        ranks.append(rank)
    dup = (nt > 0) & _dup_flag(order, rank, lengths, n_max=n_max)

    a, b = order[:-1], order[1:]
    n_of = _n_of_flat(lengths, n_max)
    n_a, n_b = n_of[a], n_of[b]
    off = torch.zeros_like(a)
    for tt in range(lmax, -1, -1):
        off = _lcp_step(off, ranks[min(tt, levels)], a, b, n_a, n_b,
                        pack_w << tt, n_max=n_max)
    _raw, lcp_pair = _pair_lcp(off, packed, a, b, n_a, n_b, n_max=n_max,
                               pack_w=pack_w)
    lcp = torch.cat([lcp_pair.new_zeros(1), lcp_pair])
    front = _collect_front(order, lcp, lengths, k=k, n_max=n_max,
                           tdeep=tdeep, pack_w=pack_w)
    tail = _collect_tail_capped(order, lcp, lengths, *front, k=k,
                                n_max=n_max, cap=cap, ecap=ecap, fcap=fcap)
    return torch.cat([torch.stack([dup.to(torch.int64), mg0]), tail,
                      nt.reshape(1)]).to(torch.int32)


def _fused_inputs(encoded: Sequence[np.ndarray]):
    """(codes (k, n_max) int8, lengths (k,) int64) host tensors."""
    sizes = np.array([len(e) for e in encoded], dtype=np.int64)
    n_max = _bucket(int(sizes.max()))
    codes = np.zeros((len(encoded), n_max), dtype=np.int8)
    for i, e in enumerate(encoded):
        codes[i, : len(e)] = e
    return torch.from_numpy(codes), torch.from_numpy(sizes)


def _rotation_final_fused(encoded: Sequence[np.ndarray], device, *,
                          pack_w: int = 12, cap: int = 4096):
    """The fused block stage's host loop (csa_tpu's
    ``_rotation_final_fused``): one run of the program in the common
    case; a retry, with a new static key, when a cached guess was too
    small: the refinement count while ties remain below the bound, then
    ``tdeep`` when ``2**tdeep`` is below the level-0 group size, ``cap``,
    ``ecap`` and ``fcap`` when their counts overflow.  ``None`` on
    duplicate rotations."""
    codes, lengths = _fused_inputs(encoded)
    k, n_max = codes.shape
    key = (k, n_max)
    bound = _num_levels(n_max, pack_w) - 1
    levels = _LEVELS_CACHE.get(key, min(LEVELS_START, bound))
    tdeep = _TDEEP_CACHE.get(key, TDEEP_START)
    ccap, ecap, fcap = _CAPS_CACHE.get(key, (cap, 0, 0))
    cap = max(cap, ccap)
    ecap = max(ecap, _pow2_at_least(cap * (k + 2), ECAP_MIN))
    fcap = max(fcap, FCAP_MIN)
    while True:
        static = dict(k=k, n_max=n_max, pack_w=pack_w, levels=levels,
                      tdeep=tdeep, cap=cap, ecap=ecap, fcap=fcap)
        with PROFILER.phase("idx.fused"):
            arr = _read(graphs.run, ("block",) + tuple(static.values()),
                        functools.partial(_fused_block_program, **static),
                        (codes, lengths), device)
        if arr[-1] > 0 and levels < bound:
            levels = min(bound, levels + LEVELS_STEP)
            continue
        _LEVELS_CACHE[key] = levels
        dup, mg0 = int(arr[0]), int(arr[1])
        if dup:
            return None
        if (1 << tdeep) < mg0:
            tdeep = _tdeep_for(mg0, k, n_max)
            _TDEEP_CACHE[key] = tdeep
            continue
        _TDEEP_CACHE[key] = tdeep
        nb, total_e, n_suffix, n_final = (int(x) for x in arr[2:6])
        if nb > cap:
            cap = _pow2_at_least(nb + 1, 4096)
            ecap = _pow2_at_least(max(ecap, cap * (k + 2)))
            continue
        if total_e + 1 > ecap:
            ecap = _pow2_at_least(total_e + 1)
            continue
        if n_final > fcap:
            fcap = _pow2_at_least(n_final + 1, 1024)
            continue
        _CAPS_CACHE[key] = (cap, ecap, fcap)
        break
    f = arr[6:-1]
    return _slim(nb, n_suffix, f[:fcap][:n_final], f[fcap:2 * fcap][:n_final],
                 f[2 * fcap:].reshape(fcap, k)[:n_final])


def _record_guesses(key, *, levels: int, mg0: int, nb: int, total_e: int,
                    n_final: int) -> None:
    """A staged call's counts for ``key`` (k, n_max) as the fused loop's
    guesses, rounded as its retries round them, so that the key's first
    fused run passes every check of the loop; a cached guess only
    grows."""
    k, n_max = key
    _LEVELS_CACHE[key] = max(levels, _LEVELS_CACHE.get(key, 0))
    _TDEEP_CACHE[key] = max(_tdeep_for(mg0, k, n_max),
                            _TDEEP_CACHE.get(key, 0))
    caps = (_pow2_at_least(nb + 1, 4096), _pow2_at_least(total_e + 1),
            _pow2_at_least(n_final + 1, 1024))
    _CAPS_CACHE[key] = tuple(map(max, caps, _CAPS_CACHE.get(key, caps)))


def _on_card(device) -> bool:
    """Whether :func:`graphs.run` captures and replays on ``device``."""
    return torch.device(device).type == "cuda"


def rotation_final(encoded: Sequence[np.ndarray], device, *,
                   pack_w: int = 12, mesh=None) -> Optional[RotationFinal]:
    """The rotation block stage: build, collect, filter.  Returns a
    :class:`RotationFinal`, or ``None`` when duplicate rotations demand
    the exact host path (periodic inputs).

    A call with no mesh, on a CUDA device, of a key ``(k, _bucket(max
    len))`` that this process has already run, with a padded size of at
    most :data:`REPLAY_MAX_CHARS`, is one fused program
    (:func:`_rotation_final_fused`: a capture at the key's second call,
    then replays of its CUDA graph).  Every other call is
    :func:`rotation_final_staged`, which records the key and its
    guesses.  The output is the same."""
    k = len(encoded)
    n_max = _bucket(max((len(e) for e in encoded), default=8))
    if (mesh is None and _on_card(device) and k * n_max <= REPLAY_MAX_CHARS
            and (k, n_max) in _CAPS_CACHE):
        return _rotation_final_fused(encoded, device, pack_w=pack_w)
    return rotation_final_staged(encoded, device, pack_w=pack_w, mesh=mesh)


def rotation_final_staged(encoded: Sequence[np.ndarray], device, *,
                          pack_w: int = 12,
                          mesh=None) -> Optional[RotationFinal]:
    """The staged block stage: the refinement ends as soon as every
    group is a singleton (one host read a level) and the block tables
    are sized from the data.  A single-device run records its key's
    guesses for the fused route (:func:`_record_guesses`).

    With ``mesh`` (a :class:`csa_tpu_torch.parallel.sharded.Mesh`) whose
    rank count is a power of two, the build and the collect front run
    over its ranks (:mod:`csa_tpu_torch.parallel.dsort_ladder`,
    :mod:`csa_tpu_torch.parallel.collect_sharded`) and the tail on the
    first rank; on any other mesh the single-device stage runs on its
    first rank.  On a mesh across processes "the first rank" is every
    process's own first rank: each runs the tail (or the whole
    single-device stage) on the same data.  The output is the same."""
    sharded = mesh is not None and mesh.size & (mesh.size - 1) == 0
    levels = None
    if sharded:
        from ..parallel import collect_sharded, dsort_ladder

        arrays, aux = dsort_ladder.device_build_dsort(encoded, mesh,
                                                      pack_w=pack_w)
    else:
        if mesh is not None:
            device = mesh.home
        arrays, aux, levels = _device_build_levels(encoded, device,
                                                   pack_w=pack_w)
    if arrays is None:
        return None
    order, lcp, lengths = arrays
    k, n_max, mg0 = aux
    kw = dict(k=k, n_max=n_max, tdeep=_tdeep_for(mg0, k, n_max),
              pack_w=pack_w)
    with PROFILER.phase("idx.collect_front"):
        if sharded:
            front = collect_sharded.collect_front(mesh, order, lcp, lengths,
                                                  **kw)
        else:
            front = _collect_front(order, lcp, lengths, **kw)
        sync(order.device)
    with PROFILER.phase("idx.collect_tail"):
        nb, total_e, n_suffix, *final = _collect_tail(
            order, lcp, lengths, *front, k=k, n_max=n_max)
    if levels is not None:
        _record_guesses((k, n_max), levels=levels, mg0=mg0, nb=nb,
                        total_e=total_e, n_final=len(final[0]))
    return _slim(nb, n_suffix, *final)


def _linear_refine(rank, real, n, t: int):
    """One linear doubling level (``rank2 = -1`` past the end): the
    order, the dense rank (pads keep ``total + g``) and whether a tie
    remains, as a device bool."""
    total = rank.shape[0]
    g = torch.arange(total, device=rank.device)
    pos2 = g + (1 << t)
    rank2 = torch.where(real & (pos2 < n), rank[pos2.clamp(max=total - 1)],
                        -1)
    # ranks < 2*total and rank2 in [-1, total): (rank, rank2 + 1) packs
    # into one int64 key with span 2*total + 1
    order = _stable_sort2(rank, rank2 + 1, 2 * total + 1)
    r1s, r2s = rank[order], rank2[order]
    samegrp = (r1s[1:] == r1s[:-1]) & (r2s[1:] == r2s[:-1])
    dense = torch.cumsum(torch.cat([samegrp.new_zeros(1),
                                    ~samegrp]).to(torch.int64), 0)
    rank = torch.empty_like(dense)
    rank[order] = dense
    return order, torch.where(real, rank, total + g), samegrp.any()


def _linear_lcp(order, stack, n, levels: int):
    """(total,) adjacent LCPs by binary descent over the rank levels;
    levels past the stack's last row use its last (final) rank."""
    total = order.shape[0]
    a, b = order[:-1], order[1:]
    off = torch.zeros_like(a)
    for tt in range(levels - 1, -1, -1):
        rk = stack[min(tt, len(stack) - 1)]
        ga, gb = a + off, b + off
        ok = (ga < n) & (gb < n)
        eq = ok & (rk[ga.clamp(max=total - 1)] == rk[gb.clamp(max=total - 1)])
        off = torch.where(eq, off + (1 << tt), off)
    return torch.cat([off.new_zeros(1), off])


def _linear_start(s, n):
    total = s.shape[0]
    g = torch.arange(total, device=s.device)
    real = g < n
    rank = torch.where(real, s, total + g)
    return rank, real, torch.sort(rank, stable=True).indices


def _linear_fused_program(s, n, *, levels: int, steps: int) -> torch.Tensor:
    """Twin of csa_tpu's ``_linear_index_device_et`` with the level loop
    unrolled to ``steps`` refinements (at least one, as the while_loop
    runs): ``s`` (total,) int64 codes, ``n`` the real length as a 0-d
    tensor.  Returns int32 ``[tied, sa(total), lcp(total)]``; ``tied``
    set means ``steps`` was too few."""
    rank, real, order = _linear_start(s, n)
    stack = [rank]
    for t in range(steps):
        order, rank, tied = _linear_refine(rank, real, n, t)
        stack.append(rank)
    lcp = _linear_lcp(order, stack, n, levels)
    return torch.cat([tied.reshape(1).to(torch.int64), order,
                      lcp]).to(torch.int32)


def linear_suffix_order(s_real: np.ndarray, device):
    """Suffix sort of ONE linear string (separators encoded below the
    characters): returns host (sa, lcp) over the real entries, the
    counterpart of ``csa_tpu.index.engine.linear_suffix_order``.

    Prefix doubling with the linear convention ``rank2 = -1`` past the end
    of the string, ended when every group is a singleton (the loop of
    ``_linear_index_device_et``); rank levels past the last realized one
    hold the final all-unique rank, so their LCP steps are no-ops exactly
    as in the JAX program.  Up to :data:`FUSED_MAX_CHARS` padded
    characters the whole sort is one fused program (a CUDA graph on a
    card) with a cached refinement count, retried larger while ties
    remain; above it the host reads one flag a level."""
    device = torch.device(device)
    n = len(s_real)
    total = _bucket(max(n, 8))
    levels = _linear_levels(total)
    s = np.zeros(total, dtype=np.int64)
    s[:n] = s_real
    s_t = torch.from_numpy(s)
    if total <= FUSED_MAX_CHARS:
        bound = levels - 1
        steps = _LINEAR_LEVELS_CACHE.get(total, min(LINEAR_LEVELS_START,
                                                    bound))
        while True:
            with PROFILER.phase("idx.fused"):
                arr = graphs.run(
                    ("linear", total, steps),
                    functools.partial(_linear_fused_program, levels=levels,
                                      steps=steps),
                    (s_t, torch.tensor(n, dtype=torch.int64)), device)
            if arr[0] and steps < bound:
                steps = min(bound, steps + LEVELS_STEP)
                continue
            _LINEAR_LEVELS_CACHE[total] = steps
            break
        sa = arr[1:total + 1].astype(np.int64)
        lcp = arr[total + 1:].astype(np.int64)
        return sa[:n], lcp[:n]
    rank, real, order = _linear_start(s_t.to(device), n)
    stack = [rank]
    t = 0
    tied = True
    while tied and t < levels - 1:
        order, rank, tied_t = _linear_refine(rank, real, n, t)
        tied = bool(tied_t)
        stack.append(rank)
        t += 1
    lcp = _linear_lcp(order, stack, n, levels)
    return order[:n].cpu().numpy(), lcp[:n].cpu().numpy()
