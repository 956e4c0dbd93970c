"""Block-chain reporting artifacts.

Produces the side files the reference emits from
``createImageAndShowResults`` (``source/csamsa.c:310-414``):

* ``<base>-positions.txt`` — color + size + per-sequence rotated positions
  for every drawn chain;
* ``<base>-Blocks.csv`` — ``Length,Sequence,Position_1..K`` rows per chain;
* stdout listing of the first 20 longest block chains;
* ``<base>-Blocks.bmp`` + ``<base>-imagemap.txt`` — the block map image
  (rendered by :mod:`csa_tpu_torch.report.blockmap`).
"""

from __future__ import annotations

import sys
from typing import Optional, TextIO

from ..io.fasta import SequenceSet
from ..rotation import pipeline as rot
from ..rotation.chains import INT_MAX


def write_blocks_artifacts(
    inputfilename: str,
    seqs: SequenceSet,
    res: rot.RotationResult,
    *,
    min_block_size: int = 10,
    max_block_size: int = INT_MAX,
    show_chains_only: bool = True,
    with_rotation: bool = True,
    log: Optional[TextIO] = None,
    n_to_print: int = 20,
    chars_to_print: int = 100,
) -> None:
    from ..cli import (
        BLOCKSIMAGE_SUFFIX,
        BLOCKSINFO_SUFFIX,
        IMAGEMAP_SUFFIX,
        POSITIONS_SUFFIX,
        output_filename,
    )
    from . import blockmap

    log = log if log is not None else sys.stdout
    k = len(seqs)
    sizes = seqs.sizes
    rotations = res.rotations if with_rotation else [0] * k

    datafile = open(output_filename(inputfilename, POSITIONS_SUFFIX), "w")
    datafile.write(f"{k}\n")
    csvfile = open(output_filename(inputfilename, BLOCKSINFO_SUFFIX), "w")
    csvfile.write("Length,Sequence")
    for i in range(k):
        csvfile.write(f",Position_{i + 1}")
    csvfile.write("\n")

    painter = blockmap.BlockMapPainter(
        sizes, rotations, output_filename(inputfilename, IMAGEMAP_SUFFIX)
    )

    chains_total = 0
    ndrawn = 0
    print(
        f"> Length, sequence and rotations for the first {n_to_print} "
        f"longest block chains:",
        file=log,
    )
    for block in res.blocks_sorted:
        if show_chains_only:
            size = block.totalsize
        else:
            size = block.depth
        positions = block.positions[:k].tolist()
        if size > 0 and min_block_size <= size <= max_block_size:
            rotated = [
                painter.draw_block_rotated(positions[i], size, i)
                for i in range(k)
            ]
            rgb = painter.next_color()
            datafile.write(f"{rgb[0]} {rgb[1]} {rgb[2]} {size}"
                           + "".join(f" {p}" for p in rotated) + "\n")
            painter.connect_blocks()
            ndrawn += 1
        if block.totalsize == -1:
            continue
        label = rot.chain_label(block, seqs)
        if chains_total < n_to_print:
            shown = (
                label
                if len(label) < chars_to_print
                else label[:chars_to_print] + "..."
            )
            print(f":: ({block.size}) {shown}", file=log)
        csvfile.write(f"{block.totalsize},{label}"
                      + "".join(f",{p}" for p in positions) + "\n")
        chains_total += 1
    if chains_total > n_to_print:
        print(f":: ... ({chains_total} total)", file=log)
    datafile.close()
    csvfile.close()

    painter.draw_labels([n.split()[0] for n in seqs.names])
    if max_block_size == INT_MAX and min_block_size == 1:
        bottom = f"{chains_total} chain blocks"
    elif max_block_size == INT_MAX:
        bottom = (
            f"{ndrawn} {'chains' if show_chains_only else 'blocks'} with "
            f"size >={min_block_size} of a total of {chains_total} block chains"
        )
    elif min_block_size == 1:
        bottom = (
            f"{ndrawn} {'chains' if show_chains_only else 'blocks'} with "
            f"size <={max_block_size} of a total of {chains_total} block chains"
        )
    else:
        bottom = (
            f"{ndrawn} {'chains' if show_chains_only else 'blocks'} with "
            f"size >={min_block_size} and <={max_block_size} of a total of "
            f"{chains_total} block chains"
        )
    painter.draw_bottom_label(bottom)
    painter.save(output_filename(inputfilename, BLOCKSIMAGE_SUFFIX))
