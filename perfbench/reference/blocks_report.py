"""Block-chain reporting artifacts (reference ``createImageAndShowResults``,
``source/csamsa.c:310-414``), frozen from the port's
``report/blocks_report.py``: ``<base>-positions.txt``,
``<base>-Blocks.csv``, ``<base>-Blocks.bmp`` and ``<base>-imagemap.txt``.
"""

from __future__ import annotations

import io
from typing import Optional, TextIO

from . import blockmap
from . import rotation as rot
from .chains import INT_MAX
from .fasta import SequenceSet

POSITIONS_SUFFIX = "-positions.txt"
IMAGEMAP_SUFFIX = "-imagemap.txt"
BLOCKSINFO_SUFFIX = "-Blocks.csv"
BLOCKSIMAGE_SUFFIX = "-Blocks.bmp"


def output_filename(inputfilename: str, extra: str) -> str:
    """Join the input file's basename with a suffix (csamsa.c:44-58)."""
    base, dot, _ = inputfilename.rpartition(".")
    if not dot:
        base = inputfilename
    return base + extra


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
    log = log if log is not None else io.StringIO()
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
        if size > 0 and min_block_size <= size <= max_block_size:
            rotated = [
                painter.draw_block_rotated(int(block.positions[i]), size, i)
                for i in range(k)
            ]
            rgb = painter.next_color()
            datafile.write(f"{rgb[0]} {rgb[1]} {rgb[2]} {size}")
            for p in rotated:
                datafile.write(f" {p}")
            datafile.write("\n")
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
        csvfile.write(f"{block.totalsize},{label}")
        for i in range(k):
            csvfile.write(f",{int(block.positions[i])}")
        csvfile.write("\n")
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
