"""The plain reference of a whole job: modes R and N of the CLI, on the
exact host engines frozen in this package, writing the same files beside
the input as ``python -m csa_tpu_torch.cli [R] <input>`` does with its
default flags.

``control`` names a broken guarantee, for the benchmark's control runs:
``"rotation_ties"`` takes equal-depth blocks in reverse order
(:func:`.rotation.analyze`), ``"dp_ties"`` lets up win a tie with diag
in the gap DP (:func:`.progressive.fill_path`).
"""

from __future__ import annotations

import io
import os
from typing import List, Optional

import numpy as np

from . import blocks_report, circular_plot, fasta, rotation, runner
from .blocks_report import output_filename

ROTATIONS_SUFFIX = "-Rotated.fasta"
ALIGNMENT_SUFFIX = "-Aligned.fasta"
CIRCULARIMAGE_SUFFIX = "-CircularAlignment.bmp"
CONTROLS = ("rotation_ties", "dp_ties")


def run(mode: str, path: str, *, control: Optional[str] = None,
        map_fn=map) -> List[str]:
    """Run ``mode`` ("R" or "N") on the FASTA file ``path``; returns the
    paths of the files written.  ``map_fn`` runs the independent gap DPs
    (:func:`.runner.run_alignment`)."""
    if mode not in ("R", "N"):
        raise ValueError(f"reference runs modes R and N, not {mode!r}")
    if control is not None and control not in CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    log = io.StringIO()
    seqs = fasta.load_fasta(path, log=log)
    fasta.discard_duplicate_rotations(seqs, log=log)
    res = rotation.analyze(seqs,
                           ties_reversed=control == "rotation_ties")
    rotfile = output_filename(path, ROTATIONS_SUFFIX)
    fasta.save_rotated(seqs, res.rotations, rotfile)
    blocks_report.write_blocks_artifacts(path, seqs, res, log=log)
    written = [rotfile] + [output_filename(path, s) for s in (
        blocks_report.POSITIONS_SUFFIX, blocks_report.BLOCKSINFO_SUFFIX,
        blocks_report.IMAGEMAP_SUFFIX, blocks_report.BLOCKSIMAGE_SUFFIX)]
    if mode == "N":
        rotated = [np.roll(e, -int(r))
                   for e, r in zip(seqs.encoded_all(), res.rotations)]
        result = runner.run_alignment(rotated, log=log,
                                      tie_up=control == "dp_ties",
                                      map_fn=map_fn)
        alignfile = output_filename(path, ALIGNMENT_SUFFIX)
        runner.save_alignment(alignfile, result, rotated, seqs.names,
                              res.rotations, log=log)
        plot = output_filename(path, CIRCULARIMAGE_SUFFIX)
        circular_plot.draw_circular_alignment_plot(alignfile, plot, log=log)
        written += [alignfile, plot]
    # the plot is not drawn when the aligned rows differ in length
    return [p for p in written if os.path.exists(p)]
