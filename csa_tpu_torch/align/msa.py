"""High-level MSA entry: rotate-view, anchor, align, save (counterpart of
:mod:`csa_tpu.align.msa`)."""

from __future__ import annotations

import sys
from typing import Optional, Sequence, TextIO

import numpy as np

from ..io import fasta as fio

from . import runner


def align(seqs: fio.SequenceSet, rotations: Sequence[int], *, device=None,
          mesh=None, backend: str = "device", log: Optional[TextIO] = None,
          match: int = 1, mismatch: int = -1, indel: int = -1,
          doublegap: int = 0) -> runner.AlignmentResult:
    """View the sequences through their rotations and align them on
    ``backend``'s route (:func:`.runner.run_alignment`)."""
    log = log if log is not None else sys.stdout
    rotated = [
        np.roll(e, -int(r)) for e, r in zip(seqs.encoded_all(), rotations)
    ]
    result = runner.run_alignment(rotated, device=device, mesh=mesh,
                                  dp_backend=backend, log=log, match=match,
                                  mismatch=mismatch, indel=indel,
                                  doublegap=doublegap)
    result.rotated_codes = rotated  # type: ignore[attr-defined]
    return result


def save_alignment(seqs: fio.SequenceSet, rotations: Sequence[int],
                   result: runner.AlignmentResult, path: str, *,
                   log: Optional[TextIO] = None) -> None:
    runner.save_alignment(
        path, result, result.rotated_codes,  # type: ignore[attr-defined]
        seqs.names, rotations, log=log,
    )
