"""Alignment orchestration: recursive anchoring + batched gap DP
(counterpart of :func:`csa_tpu.align.runner.run_alignment`).

Segments, the anchor machine, the gap-consistency heuristic and the
output writer are the JAX package's host code; the anchors' suffix sort
and the gap fills run on ``device``.
"""

from __future__ import annotations

import sys
from typing import List, Optional, TextIO

import numpy as np

from csa_tpu.align import machine
from csa_tpu.align.runner import (
    AlignmentResult,
    Segment,
    _gap_codes,
    _set_alignment_map_segments,
    _update_gap_sizes,
    save_alignment,
)

from ..utils import PROFILER
from . import anchors, progressive

__all__ = ["run_alignment", "save_alignment"]


def run_alignment(rotated_codes: List[np.ndarray], *, device,
                  log: Optional[TextIO] = None, match: int = 1,
                  mismatch: int = -1, indel: int = -1,
                  doublegap: int = 0) -> AlignmentResult:
    """PrepareTreeForAlignment + RunAlignment (alignment.c:169-214)."""
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
            gaps, device=device, match=match, mismatch=mismatch,
            indel=indel, doublegap=doublegap,
        )
        for seg, strings in zip(deferred, results):
            print(f"[({seg.mingapsize:<4}-{seg.maxgapsize:>4})", end="",
                  file=log)
            seg.alignedstrings = strings
            consize = len(strings[0]) if strings else 0
            print(f"->{consize:>4}]", file=log)
    return AlignmentResult(first, last)
