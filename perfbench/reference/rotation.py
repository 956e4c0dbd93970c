"""Rotation analysis on the exact host cyclic index (block stage ->
filters -> chains -> rotations), frozen from the port's numpy route
(``rotation/pipeline.py``; reference csamsa.c:274-303).

``ties_reversed=True`` is the benchmark's control for the rotation: the
chain list's equal-depth blocks are taken in reverse index order, which
breaks the list order that the configuration states (depth-descending,
ties in index order: insertSortedItem, nodeslinkedlists.c:34-51).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from . import chains as chains_mod
from . import cyclic
from .chains import INT_MAX, Block
from .fasta import SequenceSet


class RotationError(RuntimeError):
    pass


@dataclass
class RotationResult:
    rotations: np.ndarray  # (K,) start offset per sequence
    blocks_sorted: List[Block]  # all blocks in final (size-sorted) list order


def analyze(seqs: SequenceSet, *, max_interval: int = INT_MAX,
            ties_reversed: bool = False) -> RotationResult:
    """Optimal rotations of a set of circular sequences."""
    sizes = seqs.sizes
    index = cyclic.build_rotation_index(seqs.encoded_all())
    blocks = cyclic.collect_blocks(index)
    if len(blocks) == 0:
        raise RotationError("No unique subsequences found")
    keep = cyclic.remove_suffix_blocks(blocks)
    blocks = cyclic.BlockSet(
        blocks.index, blocks.start[keep], blocks.end[keep],
        blocks.depth[keep],
    )
    unique, positions = blocks.positions_if_unique()
    fstart = blocks.start[unique]
    fdepth = blocks.depth[unique]
    fpos = positions[unique]
    if len(fstart) == 0:
        raise RotationError("No unique subsequences found")
    order = np.lexsort((-fstart if ties_reversed else fstart, -fdepth))
    chain_blocks = [
        Block(depth=int(fdepth[i]), positions=fpos[i],
              label_ref=int(fstart[i]))
        for i in order
    ]
    chains_mod.link_blocks(
        chain_blocks, sizes, positions=fpos[order], depths=fdepth[order]
    )
    chains_mod.assemble_chains(chain_blocks, sizes, max_interval)
    blocks_sorted = chains_mod.sort_by_chain_size(chain_blocks)
    rotations = chains_mod.pick_rotations(blocks_sorted)
    if rotations is None:
        raise RotationError("No unique common subsequences found")
    return RotationResult(rotations=rotations, blocks_sorted=blocks_sorted)


def chain_label(head: Block, seqs: SequenceSet, seq_for_chars: int = 0) -> str:
    """Render a chain's label string: block characters joined by gap markers.

    Mirrors ``blockLabel`` (nodeslinkedlists.c:128-191): gaps of length <= 7
    render as that many ``-``; longer gaps render ``-(len)-``; negative
    intervals move the cursor backwards.  Characters are taken from the
    chain's occurrence in ``seq_for_chars`` (the reference mixes characters
    from whichever sequence created each tree node; the strings are equal up
    to IUPAC normalization).
    """
    text = seqs.texts[seq_for_chars]
    n = len(text)
    out: List[str] = []
    cursor = 0

    def put(s: str):
        nonlocal cursor
        for ch in s:
            if cursor < len(out):
                out[cursor] = ch
            else:
                out.extend([" "] * (cursor - len(out)))
                out.append(ch)
            cursor += 1

    b: Optional[Block] = head
    while b is not None:
        p = int(b.positions[seq_for_chars])
        chars = "".join(text[(p + j) % n] for j in range(b.depth))
        put(chars)
        gap = b.interval if b.nextblock is not None else 0
        if b.nextblock is not None:
            if gap < 0:
                cursor += gap  # reference: labelpos += n (n negative)
            elif gap > 7:
                put(f"-({gap})-")
            else:
                put("-" * gap)
        b = b.nextblock
    return "".join(out[:cursor])
