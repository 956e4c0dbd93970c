"""Block chaining and rotation selection.

Reproduces the observable semantics of the reference chain machinery
(``source/csamsa.c:132-267`` ``collectNodeChains`` /
``getRotations`` and ``source/nodeslinkedlists.c:34-77``), re-derived for a
position-array world (no suffix tree, no linked lists of tree nodes):

* Per sequence, the reference streams the text through the tree and records
  blocks in the order the matching walk *leaves* them.  Because surviving
  blocks are unique per sequence and suffix-free, that order is exactly the
  order of occurrence **end positions** ``e = pos + depth``; the walk's loop
  bound is extended once, when the first block is reported, to
  ``n + pos(first block)`` so that blocks wrapping past the origin are still
  seen (csamsa.c:164).  A block is reported iff ``e < n + pos(first)``.
* Successor links must agree across every sequence; the first sequence that
  reports a pair sets the link, any later disagreement permanently
  invalidates it (csamsa.c:155-163).
* Chains are then assembled by walking successor links in list order
  (depth-descending), merging previously formed chains, with interval sizes
  accumulated per the same arithmetic (csamsa.c:180-226).
* The final list is selection-sorted by chain size, stably, descending
  (nodeslinkedlists.c:55-77), and the head chain's positions become the
  rotations (csamsa.c:260-267).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence

import numpy as np

INT_MAX = 2**31 - 1


class ChainCycleError(RuntimeError):
    """Successor links form a cycle (the reference loops forever or
    segfaults here, csamsa.c:180-226); callers surface it as a clean
    pipeline error instead."""


@dataclass
class Block:
    """One surviving unique common block."""

    depth: int
    positions: np.ndarray  # (K,) start position in each sequence
    label_ref: int = -1  # opaque handle for label rendering (engine-defined)
    # chain state (mirrors linkedblock fields, nodeslinkedlists.h:4-13):
    nextblock: Optional["Block"] = None
    size: int = 0
    totalsize: int = 0
    interval: int = 0
    valid: bool = True  # reference encodes invalid as size == -1 pre-assembly
    # link interval cache: set by link_blocks (vectorized _pair_interval of
    # (self, self.nextblock)); None when there is no link
    next_interval: Optional[int] = None

    def __hash__(self):
        return id(self)


def reported_order(blocks: Sequence[Block], k: int, n_k: int) -> List[Block]:
    """Blocks of sequence ``k`` in the order the reference scan reports them.

    Derivation (csamsa.c:143-178): reports happen at loop index
    ``e = pos + depth``; the loop bound starts at ``n_k`` and is extended to
    ``n_k + pos(first reported block)`` when the first block is reported.
    Ends are distinct per sequence because surviving blocks are suffix-free.
    """
    if not blocks:
        return []
    ends = [(int(b.positions[k]) + b.depth, b) for b in blocks]
    ends.sort(key=lambda t: t[0])
    first_e, first_b = ends[0]
    if first_e >= n_k:  # first report would fall outside the initial bound
        return []
    window = n_k + int(first_b.positions[k])
    return [b for e, b in ends if e < window]


def link_blocks(
    blocks: Sequence[Block],
    sizes: Sequence[int],
    *,
    positions: Optional[np.ndarray] = None,
    depths: Optional[np.ndarray] = None,
) -> None:
    """Build the cross-sequence-consistent successor relation.

    csamsa.c:143-178: sequence 0's scan sets ``nextblock``; later sequences
    must observe the same immediate successor or the link is invalidated for
    good (valid=False, nextblock=None).  The last reported block of a scan
    imposes no constraint.

    Vectorized: per sequence, one stable argsort over occurrence ends
    replaces the Python report walk (each block reports at most once per
    sequence, so the in-order link updates collapse to three masked
    scatters).  Pass ``positions``/``depths`` to skip re-gathering them
    from the Block objects (the pipeline has them as arrays already).
    Per-link intervals (csamsa.c:191-197) are precomputed here in one
    (nb, k) pass and cached on ``Block.next_interval`` so the chain
    walk in :func:`assemble_chains` is O(1) per step.
    """
    nb = len(blocks)
    for b in blocks:
        b.nextblock = None
        b.size = 0
        b.totalsize = 0
        b.valid = True
        b.next_interval = None
    if nb == 0:
        return
    if positions is None:
        positions = np.stack([np.asarray(b.positions) for b in blocks])
    positions = np.asarray(positions, dtype=np.int64)
    if depths is None:
        depths = np.fromiter((b.depth for b in blocks), np.int64, nb)
    depths = np.asarray(depths, dtype=np.int64)
    sizes_arr = np.asarray(sizes, dtype=np.int64)
    num_seqs = len(sizes_arr)

    nxt = np.full(nb, -1, dtype=np.int64)
    valid = np.ones(nb, dtype=bool)
    for k in range(num_seqs):
        ends = positions[:, k] + depths
        order_k = np.argsort(ends, kind="stable")
        first = order_k[0]
        if ends[first] >= sizes_arr[k]:
            continue  # first report falls outside the initial loop bound
        window = sizes_arr[k] + positions[first, k]
        rep = order_k[ends[order_k] < window]
        prev = rep[:-1]
        cur = rep[1:]
        old = nxt[prev]
        vm = valid[prev]
        setm = vm & (old == -1)
        badm = vm & (old != -1) & (old != cur)
        nxt[prev[setm]] = cur[setm]
        nxt[prev[badm]] = -1
        valid[prev[badm]] = False

    # per-link intervals, one vectorized (links, k) pass
    has = np.nonzero(nxt >= 0)[0]
    if len(has):
        tgt = nxt[has]
        gap = positions[tgt] - (positions[has] + depths[has][:, None])
        gap += sizes_arr[None, :] * (positions[tgt] < positions[has])
        iv = gap.min(axis=1)
    if not valid.all():
        for i in np.nonzero(~valid)[0].tolist():
            blocks[i].valid = False
    for i, j, v in zip(
        has.tolist(), nxt[has].tolist(), iv.tolist() if len(has) else ()
    ):
        b = blocks[i]
        b.nextblock = blocks[j]
        b.next_interval = v


def _pair_interval(prev: Block, cur: Block, sizes: Sequence[int]) -> int:
    """Shortest inter-block gap over all sequences (csamsa.c:191-197).

    Can be negative when blocks overlap (the reference keeps the raw value).
    """
    interval = INT_MAX
    for k in range(len(sizes)):
        count = 0
        if int(cur.positions[k]) < int(prev.positions[k]):
            count += int(sizes[k])
        count += int(cur.positions[k]) - (int(prev.positions[k]) + prev.depth)
        if count < interval:
            interval = count
    return interval


def assemble_chains(
    blocks: Sequence[Block], sizes: Sequence[int], maxinterval: int = INT_MAX
) -> int:
    """Walk successor links and fold blocks into chains.

    Faithful re-derivation of the second half of ``collectNodeChains``
    (csamsa.c:180-226).  ``blocks`` must be in reference list order
    (depth-descending).  After this, chain heads have ``totalsize != -1``;
    absorbed blocks are marked ``totalsize == -1`` and carry their own depth
    as ``size``.  Returns the number of chains.
    """
    chains = len(blocks)
    # cycle detection in O(nb): a walk that re-enters a block already
    # visited DURING THIS WALK can only mean the successor links loop.
    # The epoch mark is per WALK, not per call: a block absorbed by an
    # EARLIER walk (totalsize == -1) that a later walk reaches again is
    # re-absorbed exactly as csamsa.c:216-226 does (its depth re-added,
    # chain count decremented again) — link_blocks can produce successor
    # in-degree >= 2, so cross-walk revisits are legitimate.  Only a
    # revisit within one walk — a true successor-link cycle — raises.
    for block in blocks:
        if block.totalsize == -1:
            continue
        epoch = object()
        block.size = block.depth
        block._walk_mark = epoch
        prev = block
        cur = block.nextblock
        while cur is not None:
            interval = prev.next_interval
            if interval is None:  # manually built lists (tests/tools)
                interval = _pair_interval(prev, cur, sizes)
            if interval > maxinterval:
                prev.nextblock = None
                break
            if cur.totalsize > 0:
                # absorbing a previously-formed chain (csamsa.c:202-211).
                # ``cur is block`` happens legitimately on cyclic genomes:
                # the successor links wrap the circle back to the walking
                # head (whose interval accumulation made totalsize > 0)
                # and the chain folds into itself exactly as the
                # reference's accounting does.
                block.size += cur.size
                block.totalsize += cur.totalsize
                prev.interval = interval
                block.totalsize += interval
                cur.size = cur.depth
                cur.totalsize = -1
                chains -= 1
                break
            # reaching an epoch-marked block on the continue path means
            # the links loop (absorbing a previously-formed chain head —
            # the legitimate revisit — breaks above before this check)
            if getattr(cur, "_walk_mark", None) is epoch:
                raise ChainCycleError(
                    "block successor links form a cycle; no consistent "
                    "chain ordering exists for this input"
                )
            cur._walk_mark = epoch
            cur.size = cur.depth
            block.size += cur.size
            prev.interval = interval
            block.totalsize += interval
            cur.totalsize = -1
            chains -= 1
            prev = cur
            cur = cur.nextblock
        block.totalsize += block.size
    return chains


def sort_by_chain_size(blocks: List[Block]) -> List[Block]:
    """Stable descending sort by ``size`` (selection sort semantics of
    nodeslinkedlists.c:55-77: strict '>' keeps earlier elements first on
    ties)."""
    return sorted(blocks, key=lambda b: -b.size)


def pick_rotations(blocks_sorted: List[Block]) -> Optional[np.ndarray]:
    """Positions of the head of the size-sorted list (csamsa.c:260-267)."""
    if not blocks_sorted:
        return None
    return np.asarray(blocks_sorted[0].positions, dtype=np.int64).copy()


def chain_members(head: Block) -> List[Block]:
    members = []
    b: Optional[Block] = head
    seen = set()
    while b is not None and id(b) not in seen:
        members.append(b)
        seen.add(id(b))
        b = b.nextblock
    return members
