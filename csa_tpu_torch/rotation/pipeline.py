"""Rotation analysis: block stage -> filters -> chains -> rotations
(counterpart of :func:`csa_tpu.rotation.pipeline.analyze`).

The block stage (index build, collect cascade, suffix and uniqueness
filters) runs on ``device``, or over the ranks of ``mesh``, through
:func:`..index.engine.rotation_final`;
the chain linking and selection are the exact host code of
:mod:`csa_tpu_torch.rotation.chains`.
A sequence with duplicate rotations (a periodic input) takes the exact
host cyclic index, as ``csa_tpu`` does: an algorithmic branch, not a
device fallback, and it is reported on stderr when taken.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import List, Optional, TextIO

import numpy as np

from ..index import cyclic, engine
from ..io.fasta import SequenceSet
from ..utils import PROFILER
from . import chains as chains_mod
from .chains import INT_MAX, Block

__all__ = ["analyze", "chain_label", "RotationError", "RotationResult"]


class RotationError(RuntimeError):
    pass


@dataclass
class RotationResult:
    rotations: np.ndarray  # (K,) start offset per sequence
    blocks_sorted: List[Block]  # all blocks in final (size-sorted) list order
    num_collected: int
    num_after_suffix: int
    num_after_unique: int
    num_chains: int
    index: Optional[cyclic.RotationIndex] = None
    block_depths: np.ndarray = field(default_factory=lambda: np.empty(0))


def analyze(
    seqs: SequenceSet,
    *,
    device,
    pack_w: int = 12,
    max_interval: int = INT_MAX,
    log: Optional[TextIO] = None,
    mesh=None,
) -> RotationResult:
    """Optimal rotations of a set of circular sequences.  The console
    narrative is the JAX package's (reference csamsa.c:274-303).  With
    ``mesh`` (``--backend sharded``) the block stage runs over its ranks
    and ``device`` is not used."""
    log = log if log is not None else sys.stdout
    sizes = seqs.sizes
    encoded = seqs.encoded_all()

    stage = "torch" if mesh is None else "sharded"
    with PROFILER.phase(f"rot.block_stage[{stage}]"):
        fused = engine.rotation_final(encoded, device, pack_w=pack_w,
                                      mesh=mesh)

    index = None
    if fused is not None:
        print("> Collecting maximum common subsequences... ", end="", file=log)
        num_collected = fused.num_collected
        print(f"{num_collected} nodes found", file=log)
        if num_collected == 0:
            raise RotationError("No unique subsequences found")
        print("> Removing suffixes... ", end="", file=log)
        num_after_suffix = fused.num_after_suffix
        fstart = fused.final_start
        fdepth = fused.final_depth
        fpos = fused.final_positions
        print(f"{num_after_suffix} nodes left", file=log)
        print("> Removing repeats... ", end="", file=log)
    else:
        print("> note: duplicate rotations within a sequence; the block "
              "stage runs on the exact host cyclic index", file=sys.stderr)
        index = cyclic.build_rotation_index(encoded)
        blocks = cyclic.collect_blocks(index)

        print("> Collecting maximum common subsequences... ", end="", file=log)
        num_collected = len(blocks)
        print(f"{num_collected} nodes found", file=log)
        if num_collected == 0:
            raise RotationError("No unique subsequences found")

        print("> Removing suffixes... ", end="", file=log)
        keep = cyclic.remove_suffix_blocks(blocks)
        blocks = cyclic.BlockSet(
            blocks.index, blocks.start[keep], blocks.end[keep],
            blocks.depth[keep],
        )
        num_after_suffix = len(blocks)
        print(f"{num_after_suffix} nodes left", file=log)

        print("> Removing repeats... ", end="", file=log)
        unique, positions = blocks.positions_if_unique()
        fstart = blocks.start[unique]
        fdepth = blocks.depth[unique]
        fpos = positions[unique]
    num_after_unique = len(fstart)

    if num_after_unique == 0:
        raise RotationError("No unique subsequences found")
    print(f"{num_after_unique} nodes left", file=log)

    print("> Connecting block chains... ", end="", file=log)
    with PROFILER.phase("rot.chains"):
        # reference list order: depth-descending (insertSortedItem,
        # nodeslinkedlists.c:34-51); ties keep the engine order
        order = np.lexsort((fstart, -fdepth))
        chain_blocks = [
            Block(depth=int(fdepth[i]), positions=fpos[i],
                  label_ref=int(fstart[i]))
            for i in order
        ]
        chains_mod.link_blocks(
            chain_blocks, sizes, positions=fpos[order], depths=fdepth[order]
        )
        try:
            num_chains = chains_mod.assemble_chains(chain_blocks, sizes,
                                                    max_interval)
        except chains_mod.ChainCycleError as e:
            raise RotationError(str(e)) from e
        print(f"{num_chains} chains found", file=log)
        blocks_sorted = chains_mod.sort_by_chain_size(chain_blocks)
        rotations = chains_mod.pick_rotations(blocks_sorted)
    if rotations is None:
        raise RotationError("No unique common subsequences found")

    return RotationResult(
        rotations=rotations,
        blocks_sorted=blocks_sorted,
        num_collected=num_collected,
        num_after_suffix=num_after_suffix,
        num_after_unique=num_after_unique,
        num_chains=num_chains,
        index=index,
        block_depths=fdepth[order] if len(order) else np.empty(0),
    )


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
