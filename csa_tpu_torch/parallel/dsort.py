"""Shard-local distributed sort by block-bitonic merge-split (counterpart
of :mod:`csa_tpu.parallel.dsort`).

Each rank sorts its block of S keys once (a stable ``torch.sort``); the
D sorted blocks are then merged by a bitonic merge-split network of
``log2(D) (log2(D) + 1) / 2`` stages.  In a stage every rank swaps its
whole block with the partner ``rank ^ bit`` (:meth:`Ranks.ppermute`)
and keeps the lower or upper half of the pairwise merge.  Merge-split of
sorted blocks driven by a sorting network sorts the whole sequence (the
0-1 principle lifted to blocks), so the result is exact, with fixed
message sizes.

A pairwise merge is an O(S) interleave: two ``torch.searchsorted``
rank computations and two scatters, not a 2S re-sort.  JAX drops the
scatters' out-of-half indices (``mode="drop"``) where torch raises, so
they are sent to an (S + 1)-th slot that is cut off.

Keys may tie in :func:`net_sort_pairs`.  Both partners of a stage
compute the same merge, one keeping the low half and one the high, so
they must order ties the same way: the block of the lower rank goes
first (``a_first``).  A tie order that differed between them would lose
or duplicate elements.  :func:`sharded_argsort` makes its keys unique by
packing the index below the value, so its result is the stable order.
D must be a power of two.
"""

from __future__ import annotations

import torch

from .sharded import Mesh, Ranks, relabel, unzip


def _merge_split_net(num_dev: int):
    """The network's stages for ``num_dev`` (a power of two) blocks:
    ``(bit, keep_low)`` a stage, the partner of rank s being ``s ^ bit``
    and ``keep_low[s]`` whether s keeps the lower half."""
    if num_dev < 1 or num_dev & (num_dev - 1):
        raise ValueError(f"rank count must be a power of two, got {num_dev}")
    m = num_dev.bit_length() - 1
    stages = []
    for kk in range(1, m + 1):
        for j in reversed(range(kk)):
            bit = 1 << j
            keep_low = [(s < s ^ bit) == (((s >> kk) & 1) == 0)
                        for s in range(num_dev)]
            stages.append((bit, keep_low))
    return stages


def _merge_dest(ka, kb, keep_low: bool, a_first: bool):
    """Slots in this rank's half of the merge of sorted blocks ``ka``
    (this rank's) and ``kb``: element i of a block lands at i plus the
    number of the other block's elements before it; ties put ``ka``'s
    elements first when ``a_first``.  Out-of-half slots become S."""
    S = ka.shape[0]
    ar = torch.arange(S, device=ka.device)
    ra = ar + torch.searchsorted(kb, ka, side="left" if a_first else "right")
    rb = ar + torch.searchsorted(ka, kb, side="right" if a_first else "left")
    lo = 0 if keep_low else S
    ia, ib = ra - lo, rb - lo
    ia = torch.where((ia >= 0) & (ia < S), ia, S)
    ib = torch.where((ib >= 0) & (ib < S), ib, S)
    return ia, ib


def _scatter_half(xa, xb, ia, ib):
    """The half: ``xa`` and ``xb`` written to their slots (a bijection
    onto 0..S-1 beside the dropped slot S)."""
    out = xa.new_empty(xa.shape[0] + 1)
    out[ia] = xa
    out[ib] = xb
    return out[:-1]


def _merge_halves(a, b, keep_low: bool):
    """Lower or upper half of the merge of two sorted blocks of UNIQUE
    keys."""
    ia, ib = _merge_dest(a, b, keep_low, True)
    return _scatter_half(a, b, ia, ib)


def _merge_halves_pair(ka, pa, kb, pb, keep_low: bool, a_first: bool):
    """Merge-split of two sorted (key, payload) blocks whose keys may
    tie; the payloads ride the keys' slots."""
    ia, ib = _merge_dest(ka, kb, keep_low, a_first)
    return _scatter_half(ka, kb, ia, ib), _scatter_half(pa, pb, ia, ib)


def _network(ranks: Ranks, blocks: list, merge) -> list:
    """Run the merge-split stages over one sorted block a rank (a tuple
    of tensors); ``merge(mine, theirs, keep_low, a_first)`` is a stage's
    pairwise merge."""
    width = len(blocks[ranks.home])
    for bit, keep_low in _merge_split_net(ranks.size):
        pairs = [(s, s ^ bit) for s in range(ranks.size)]
        theirs = [ranks.ppermute(part, pairs)
                  for part in unzip(blocks, width)]
        blocks = ranks.each(
            lambda r, mine, *other: merge(mine, other, keep_low[r],
                                          (r & bit) == 0),
            blocks, *theirs)
    return blocks


def net_sort_pairs(ranks: Ranks, keys: list, payloads: list):
    """Distributed sort of (int64 key, payload) pairs: one shard of each a
    rank in, the shards of the key-sorted pairs out.  Ties are merged
    stably within a stage, lower rank first across blocks; that order
    is deterministic but not the global stable order."""
    _merge_split_net(ranks.size)   # a power of two, or it raises

    def local(r, u, p):
        u, idx = torch.sort(u, stable=True)
        return u, p[idx]

    blocks = ranks.each(local, keys, payloads)
    blocks = _network(
        ranks, blocks,
        lambda m, t, lo, af: _merge_halves_pair(m[0], m[1], t[0], t[1], lo,
                                                af))
    return unzip(blocks, 2)


def sharded_argsort(values, mesh: Mesh):
    """Distributed stable argsort of a 1-D int32 array or tensor whose
    length the mesh's rank count divides: ``(sorted values, order)`` on
    the home rank's device (every process's first), equal to
    ``torch.sort(values, stable=True)``.

    Each value is packed with its index into one unique int64 key,
    ``v << 32 | g``, so int64 order is (value, index) order over the
    whole signed int32 range, and the keys sort alone."""
    D = mesh.size
    _merge_split_net(D)
    v = torch.as_tensor(values).to(mesh.home, torch.int64)
    n = v.shape[0]
    if n % D:
        raise ValueError(f"sharded_argsort: {D} ranks do not divide {n}")
    u = (v << 32) | torch.arange(n, device=v.device)
    ranks = Ranks(relabel(mesh, "x"))   # its streams wait for u
    shards = ranks.each(lambda r, s: (torch.sort(s).values,),
                        ranks.scatter(u))
    shards = _network(ranks, shards,
                      lambda m, t, lo, af: (_merge_halves(m[0], t[0], lo),))
    su = ranks.gather_to_first(unzip(shards, 1)[0])
    with ranks.on(ranks.home):
        vals = (su >> 32).to(torch.int32)
        order = su & 0xFFFFFFFF
    ranks.finish(vals, order)
    return vals, order
