"""Alignment orchestration: recursive anchoring + batched gap DP + output
(the port's counterpart of :mod:`csa_tpu.align.runner`).

Exact-behavior equivalent of the reference's alignment routines
(``source/alignment.c`` ``RunAlignment`` :169-214, ``SaveAlignment``
:91-166) and segment management (``alignmentmap.c``
``SetAlignmentMapSegments`` :259-315, ``UpdateSegmentGapSizes``
:240-255).  Segments, the gap-consistency heuristic and the output
writer are host code copied from the JAX package; the anchors' suffix
sort and the gap fills run on ``device``.

The working coordinate system is the *rotated* sequences: position ``p``
of sequence ``i`` is ``texts[i][(rotations[i] + p) % n_i]``
(alignment.c:16-20 ``CharAt``).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import List, Optional, Sequence, TextIO

import numpy as np

from ..utils import PROFILER
from . import anchors, machine, progressive

__all__ = ["run_alignment", "save_alignment"]

INT_MAX = 2**31 - 1
INT_MIN = -(2**31)


class Segment:
    __slots__ = ("positions", "size", "mingapsize", "maxgapsize", "alignedstrings", "next")

    def __init__(self, positions: np.ndarray, size: int):
        self.positions = positions  # (k,) rotated coordinates
        self.size = size
        self.mingapsize = INT_MAX
        self.maxgapsize = INT_MAX
        self.alignedstrings: Optional[List[np.ndarray]] = None
        self.next: Optional["Segment"] = None


def _update_gap_sizes(segment: Segment, textsizes: np.ndarray):
    """UpdateSegmentGapSizes (alignmentmap.c:240-255)."""
    start = segment.positions + segment.size
    end = segment.next.positions
    gaps = end - start
    gaps = np.where(gaps < 0, gaps + textsizes, gaps)
    segment.mingapsize = int(gaps.min())
    segment.maxgapsize = int(gaps.max())


@dataclass
class AlignmentResult:
    first_segment: Segment
    last_segment: Segment
    alignment_size: int = 0
    segment_count: int = 0

    def segments(self):
        s = self.first_segment
        while s is not None:
            yield s
            s = s.next

def run_alignment(rotated_codes: List[np.ndarray], *, device, mesh=None,
                  log: Optional[TextIO] = None, match: int = 1,
                  mismatch: int = -1, indel: int = -1,
                  doublegap: int = 0) -> AlignmentResult:
    """PrepareTreeForAlignment + RunAlignment (alignment.c:169-214).
    ``mesh`` (a :class:`csa_tpu_torch.parallel.sharded.Mesh`) spreads the
    gap DP over its ranks, as ``--backend sharded`` does in ``csa_tpu``."""
    log = log if log is not None else sys.stdout
    k = len(rotated_codes)
    textsizes = np.array([len(c) for c in rotated_codes], dtype=np.int64)

    print("> Preparing tree for alignment...", end="", file=log)
    with PROFILER.phase("align.anchors"):
        nodes = anchors.compute_border_nodes(rotated_codes, device)
    with PROFILER.phase("align.machine_init"):
        blist = machine.BorderList(nodes, k)
    print(" ok", file=log)

    first = Segment(np.full(k, -1, dtype=np.int64), 1)
    last = Segment(textsizes.copy(), 0)
    first.next = last
    _update_gap_sizes(first, textsizes)

    # the gap DPs are independent and never feed the anchoring loop, so
    # they are deferred and batched after it; results print in segment
    # order, so the log text matches the reference's interleaved output
    deferred: List[Segment] = []
    startsegment = first
    while startsegment is not last:
        endsegment = startsegment.next
        if startsegment.mingapsize == 0:
            startsegment = startsegment.next
            continue
        startpos = [int(x) for x in (startsegment.positions + startsegment.size)]
        endpos = [int(x) for x in endsegment.positions]
        with PROFILER.phase("align.active_window"):
            count = blist.update_active(startpos, endpos)
        if count > 0:
            with PROFILER.phase("align.his_chain"):
                chain = blist.calculate_his(endpos)
            count = _set_alignment_map_segments(
                chain, startsegment, endsegment, textsizes
            )
        if count == 0:
            if startsegment.maxgapsize != 0:
                deferred.append(startsegment)
            startsegment = startsegment.next
    if deferred:
        gaps = [_gap_codes(seg, rotated_codes) for seg in deferred]
        results = progressive.progressive_dp_batched(
            gaps, device=device, mesh=mesh, match=match, mismatch=mismatch,
            indel=indel, doublegap=doublegap,
        )
        for seg, strings in zip(deferred, results):
            print(f"[({seg.mingapsize:<4}-{seg.maxgapsize:>4})", end="",
                  file=log)
            seg.alignedstrings = strings
            consize = len(strings[0]) if strings else 0
            print(f"->{consize:>4}]", file=log)
    return AlignmentResult(first, last)


def _gap_codes(segment: Segment, rotated_codes: List[np.ndarray]):
    k = len(rotated_codes)
    out = []
    for i in range(k):
        start = int(segment.positions[i]) + segment.size
        end = int(segment.next.positions[i])
        out.append(np.asarray(rotated_codes[i][start:end], dtype=np.int8))
    return out


def _set_alignment_map_segments(
    chain: List[machine.ChainItem],
    startsegment: Segment,
    endsegment: Segment,
    textsizes: np.ndarray,
) -> int:
    """SetAlignmentMapSegments (alignmentmap.c:259-315), exact including
    the gap-consistency discard heuristic (:282-296)."""
    k = len(textsizes)
    current = endsegment
    item = chain[0] if chain else None
    count = 0
    while item is not None:
        newsegment = Segment(item.positions.copy(), item.size)
        newsegment.next = current
        _update_gap_sizes(newsegment, textsizes)
        start = newsegment.positions + newsegment.size
        end = current.positions
        gaps = end - start
        gaps = np.where(gaps < 0, gaps + textsizes, gaps)
        sizesum = int(gaps.sum())
        mn = newsegment.mingapsize
        mx = newsegment.maxgapsize
        averagemin = (sizesum - mn) // (k - 1)
        averagemax = (sizesum - mx) // (k - 1)
        if mn < (averagemin // 2) or mx > ((averagemax * 3) // 2):
            pass  # discard, keep same gap-ending segment
        else:
            current = newsegment
            count += 1
        item = item.backtrack
    startsegment.next = current
    _update_gap_sizes(startsegment, textsizes)
    return count


GAP_CODE = 4
_CODE2CHAR = np.frombuffer(b"ACGT-", dtype=np.uint8)


def render_alignment(
    result: AlignmentResult,
    rotated_codes: List[np.ndarray],
) -> List[np.ndarray]:
    """Materialize the per-sequence aligned code strings (SaveAlignment's
    traversal, alignment.c:110-159, in rotated coordinates)."""
    k = len(rotated_codes)
    out: List[List[np.ndarray]] = [[] for _ in range(k)]
    first = result.first_segment
    last = result.last_segment
    segment = first
    segmentcount = 0
    alignlength = 0
    while segment is not last:
        if segment is not first:
            alignlength += segment.size
            for i in range(k):
                s = int(segment.positions[i])
                out[i].append(
                    np.asarray(
                        rotated_codes[i][s : s + segment.size], dtype=np.int8
                    )
                )
        if segment.alignedstrings is not None:
            alignlength += len(segment.alignedstrings[0])
            for i in range(k):
                out[i].append(np.asarray(segment.alignedstrings[i], dtype=np.int8))
        # When no DP ran for this gap (mingapsize 0 with maxgapsize > 0,
        # skipped by RunAlignment), the reference emits NOTHING for it:
        # SaveAlignment's per-gap output is gated on alignedstrings being
        # non-NULL (alignment.c:135), silently dropping the gap characters
        # of the longer sequences.  Its own integrity check then reports a
        # mismatch.  Reproduced for byte parity; see docs/PARITY.md.
        segment = segment.next
        segmentcount += 1
    result.alignment_size = alignlength
    result.segment_count = segmentcount
    return [
        np.concatenate(parts) if parts else np.zeros(0, dtype=np.int8)
        for parts in out
    ]


def save_alignment(
    path: str,
    result: AlignmentResult,
    rotated_codes: List[np.ndarray],
    descs: Sequence[str],
    rotations: Optional[Sequence[int]],
    *,
    log: Optional[TextIO] = None,
):
    """SaveAlignment (alignment.c:91-166): write the aligned multi-FASTA."""
    log = log if log is not None else sys.stdout
    aligned = render_alignment(result, rotated_codes)
    with open(path, "w") as f:
        for i, desc in enumerate(descs):
            if rotations is not None:
                f.write(f">{desc} @ {int(rotations[i])}\n")
            else:
                f.write(f">{desc}\n")
            f.write(_CODE2CHAR[aligned[i]].tobytes().decode("ascii"))
            f.write("\n")
    print(
        f"> Alignment size: {result.alignment_size} "
        f"({result.segment_count} alignment segments)",
        file=log,
    )
