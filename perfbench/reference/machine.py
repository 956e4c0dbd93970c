"""Border-node list machine: active-window filtering, sorting, hiding, HIS.

Exact-behavior emulation of the reference's alignment-phase list machinery
(``source/morenodeslinkedlists.c`` ``UpdateActiveBorderNodes``
:474-530, ``SortBorderNodes`` :411-453, ``HideBorderNode`` :104-127,
``HideFirstPositions`` :149-173, ``ReSortBorderNode`` :456-471) and the
chain construction (``alignmentmap.c`` ``CalculateHeaviestIncreasingSubsequence``
:107-143, ``NewChainItem`` :9-31, ``SetAlignmentMapSegments`` :259-315).

Notable reference behaviors reproduced deliberately (see docs/PARITY.md):

* hidden *positions* are never restored: ``UnHidePositions`` early-returns
  because ``UnHideBorderNodes`` (always executed first) clears
  ``hiddennode`` — so ``HideFirstPositions`` is a permanent consumption,
  modeled as a front-pointer advance;
* deleting a storage node orphans the nodes hidden inside it forever;
* the HIS is the reference's greedy weight-list algorithm, not an optimal
  heaviest increasing subsequence.
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .anchors import BorderNode

INT_MAX = 2**31 - 1


class ListNode:
    """Doubly linked border-node list entry.

    positions are plain Python int lists: the machine's hot loops do
    tiny per-node scans and binary searches where list indexing and
    bisect beat numpy-scalar ufunc dispatch by ~5x."""

    __slots__ = (
        "size",
        "positions",
        "front",
        "activeposcount",
        "hidden",
        "hidden_nodes",
        "prev",
        "next",
    )

    def __init__(self, size: int, positions: List[List[int]]):
        self.size = size
        self.positions = positions
        self.front = [0] * len(positions)
        self.activeposcount = [0] * len(positions)
        self.hidden = False
        self.hidden_nodes: List["ListNode"] = []  # in hide order
        self.prev: Optional[ListNode] = None
        self.next: Optional[ListNode] = None

    def first_pos(self, seq: int) -> int:
        return self.positions[seq][self.front[seq]]

    def npos(self, seq: int) -> int:
        return len(self.positions[seq]) - self.front[seq]


@dataclass
class ChainItem:
    positions: np.ndarray  # (k,)
    size: int
    weight: int
    backtrack: Optional["ChainItem"] = None


class BorderList:
    """The live border-node list for one alignment run."""

    def __init__(self, nodes: List[BorderNode], num_seqs: int):
        self.k = num_seqs
        # fake first node: position -1 in every sequence (alignment.c:44-53)
        self.first = ListNode(0, [[-1]] * num_seqs)
        prev = self.first
        # initial order: ascending first position in sequence 0.  The very
        # first UpdateActiveBorderNodes call fully sorts by that key before
        # anything order-dependent happens (first-window start positions
        # are 0, so no deletions precede the sort), making the collection
        # (DFS) order of the reference irrelevant; positions are disjoint
        # across nodes so the key is unique.
        for bn in sorted(nodes, key=lambda b: int(b.positions[0][0])):
            ln = ListNode(
                bn.size,
                [
                    p if isinstance(p, list) else np.asarray(p).tolist()
                    for p in bn.positions
                ],
            )
            prev.next = ln
            ln.prev = prev
            prev = ln

    # ---- structural helpers -------------------------------------------
    def _unlink(self, node: ListNode):
        if node.prev is not None:
            node.prev.next = node.next
        if node.next is not None:
            node.next.prev = node.prev
        node.prev = None
        node.next = None

    def delete_node(self, node: ListNode):
        """DeleteBorderNode: remove from the list (hidden nodes inside it
        are orphaned, as in the reference)."""
        self._unlink(node)

    def hide_node(self, node: ListNode):
        """HideBorderNode: stash the node inside its predecessor."""
        if node.hidden:
            return
        storage = node.prev
        storage.next = node.next
        if node.next is not None:
            node.next.prev = storage
        node.next = None
        node.prev = None
        storage.hidden_nodes.append(node)
        node.hidden = True

    def unhide_nodes(self, node: ListNode):
        """UnHideBorderNodes: splice the hidden chain right after node,
        earliest-hidden first."""
        if not node.hidden_nodes:
            return
        chain = node.hidden_nodes
        node.hidden_nodes = []
        after = node.next
        prev = node
        for h in chain:
            h.hidden = False
            prev.next = h
            h.prev = prev
            prev = h
        prev.next = after
        if after is not None:
            after.prev = prev

    # ---- the reference's block insertion sort -------------------------
    def sort_nodes(self, endpos0: int):
        """SortBorderNodes (morenodeslinkedlists.c:411-453), exact."""
        current = self.first.next
        while current is not None and current.first_pos(0) < endpos0:
            prevnode = current.prev
            if current.first_pos(0) < prevnode.first_pos(0):
                back = current.prev
                while back is not None and back.first_pos(0) > current.first_pos(0):
                    back = back.prev
                following = back.next
                back.next = current
                current.prev = back
                fwd = current
                while (
                    fwd.next is not None
                    and fwd.next.first_pos(0) > fwd.first_pos(0)
                    and fwd.next.first_pos(0) < following.first_pos(0)
                ):
                    fwd = fwd.next
                nextnode = fwd.next
                fwd.next = following
                following.prev = fwd
                prevnode.next = nextnode
                if nextnode is not None:
                    nextnode.prev = prevnode
            else:
                nextnode = current.next
            current = nextnode

    def resort_node(self, node: ListNode):
        """ReSortBorderNode (morenodeslinkedlists.c:456-471), exact."""
        if node.next is None or node.next.first_pos(0) > node.first_pos(0):
            return
        current = node.next
        while (
            current.next is not None
            and current.next.first_pos(0) < node.first_pos(0)
        ):
            current = current.next
        prevnode = node.prev
        nextnode = node.next
        if prevnode is not None:
            prevnode.next = nextnode
        if nextnode is not None:
            nextnode.prev = prevnode
        nxt = current.next
        current.next = node
        node.prev = current
        if nxt is not None:
            nxt.prev = node
        node.next = nxt

    # ---- per-gap activation -------------------------------------------
    def update_active(self, startpos: List[int], endpos: List[int]) -> int:
        """UpdateActiveBorderNodes (morenodeslinkedlists.c:474-530)."""
        k = self.k
        node = self.first.next
        while node is not None and node.first_pos(0) < endpos[0]:
            if node.hidden_nodes:
                self.unhide_nodes(node)
            # UnHidePositions: no-op in the reference (early return), so
            # nothing to restore here
            nextnode = node.next
            for i in range(k):
                p = node.positions[i]
                f = node.front[i]
                # front advance = bisect: positions are ascending
                f = bisect_left(p, startpos[i], f)
                node.front[i] = f
                if f >= len(p):
                    self.delete_node(node)
                    break
            node = nextnode
        self.sort_nodes(endpos[0])
        active = 0
        node = self.first.next
        while node is not None and node.first_pos(0) < endpos[0]:
            active += 1
            broke = False
            for i in range(k):
                p = node.positions[i]
                f = node.front[i]
                cnt = bisect_left(p, endpos[i], f) - f
                if cnt == 0:
                    broke = True
                    break
                node.activeposcount[i] = cnt
            nextnode = node.next
            if broke:
                self.hide_node(node)
                active -= 1
                node = nextnode
                continue
            cnt0 = node.activeposcount[0]
            for i in range(1, k):
                if node.activeposcount[i] != cnt0:
                    self.hide_node(node)
                    active -= 1
                    break
            node = nextnode
        return active

    # ---- HIS chain -----------------------------------------------------
    def calculate_his(self, endpos: List[int]) -> List[ChainItem]:
        """CalculateHeaviestIncreasingSubsequence (alignmentmap.c:107-143).

        Returns the chain as a list in decreasing-weight order (head
        first); items carry backtrack links.

        The weight-descending list is kept in ~BLK-item blocks (sqrt
        decomposition): the GreaterThan scan evaluates one block at a
        time from the head and stops at the first hit (the reference's
        early-exit walk, alignmentmap.c:117-124 — the previous
        full-array ``np.all`` + ``np.insert`` formulation was O(M^2 k)
        and dominated Mbp-scale alignment: 125 s of a 131 s 8x100 kbp
        run, hours at 8x1 Mbp), and insertion touches one block.  Order
        semantics are identical: first block whose minimum weight is
        <= the new weight receives the item before its first
        weight-<= entry, so equal-weight items keep insertion order
        exactly as the reference's backward walk leaves them.
        """
        k = self.k
        BLK = 2048
        CAP = 2 * BLK + 2

        class _Blk:
            __slots__ = ("end", "w", "items", "n")

            def __init__(self):
                # capacity arrays + in-place shifted inserts: ~2x the
                # np.insert reallocation; the (positions) columns are
                # write-only in the scan and not stored at all
                self.end = np.empty((CAP, k), dtype=np.int64)
                self.w = np.empty(CAP, dtype=np.int64)
                self.items: List[ChainItem] = []
                self.n = 0

        blocks: List[_Blk] = []
        endpos_arr = np.asarray(endpos, dtype=np.int64)

        node = self.first.next
        while node is not None and node.first_pos(0) < endpos[0]:
            positions = np.array(
                [node.positions[i][node.front[i]] for i in range(k)],
                dtype=np.int64,
            )
            actualsize = node.size
            newsize = actualsize
            trims = endpos_arr - positions
            mask = positions + actualsize >= endpos_arr
            if np.any(mask):
                newsize = min(newsize, int(trims[mask].min()))
            item = ChainItem(positions=positions, size=newsize, weight=newsize)

            # first chain item (in weight order) entirely below this
            # one; the hit is almost always within the first few
            # entries of the head block (the current heaviest chains),
            # so probe a 64-row prefix before the full block
            hit_b = hit_j = None
            for b in blocks:
                if b.n > 64:
                    ge = (positions >= b.end[:64]).all(axis=1)
                    if ge.any():
                        hit_b, hit_j = b, int(np.argmax(ge))
                        break
                ge = (positions >= b.end[: b.n]).all(axis=1)
                if ge.any():
                    hit_b, hit_j = b, int(np.argmax(ge))
                    break
            if hit_b is not None:
                item.weight += int(hit_b.w[hit_j])
                item.backtrack = hit_b.items[hit_j]

            # insertion: first index (from head) with weight <= new
            # (the reference's backward walk from the GreaterThan hit
            # lands there because weights are kept descending and the
            # hit's weight is strictly below the new weight)
            w = item.weight
            target = None
            for b in blocks:
                if b.n == 0 or b.w[b.n - 1] <= w:
                    target = b
                    break
            if target is None:
                if not blocks or blocks[-1].n >= 2 * BLK:
                    blocks.append(_Blk())
                target = blocks[-1]
                ins = target.n
            else:
                ins = int(
                    np.searchsorted(-target.w[: target.n], -w, side="left")
                )
            n = target.n
            target.end[ins + 1 : n + 1] = target.end[ins:n]
            target.end[ins] = positions + item.size
            target.w[ins + 1 : n + 1] = target.w[ins:n]
            target.w[ins] = w
            target.items.insert(ins, item)
            target.n = n + 1
            if target.n > 2 * BLK:
                # split the block in half; order is preserved
                h = target.n // 2
                tail = _Blk()
                tail.n = target.n - h
                tail.end[: tail.n] = target.end[h : target.n]
                tail.w[: tail.n] = target.w[h : target.n]
                tail.items = target.items[h:]
                target.items = target.items[:h]
                target.n = h
                blocks.insert(blocks.index(target) + 1, tail)

            nextnode = node.next
            if node.activeposcount[0] > 1:
                # HideFirstPositions: permanent front advance
                for i in range(k):
                    node.front[i] += 1
                    node.activeposcount[i] -= 1
                self.resort_node(node)
                if node.next is nextnode:
                    nextnode = node
            node = nextnode
        chain: List[ChainItem] = []
        for b in blocks:
            chain.extend(b.items)
        return chain
