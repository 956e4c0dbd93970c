"""Rotation-verification oracle on the pairwise NW kernel (counterpart of
:mod:`csa_tpu.rotation.verification`).

After the chain stage picks per-sequence rotations, every chosen rotation
is scored against sequence 0's chosen rotation by global Needleman-Wunsch
(:func:`csa_tpu_torch.dp.nw.pairwise_nw_scores`) and compared with
``samples`` alternative (deterministically spread) rotations of the same
sequence.  A chosen rotation that scores below an alternative is flagged:
a cheap independent check that the combinatorial chain stage picked an
alignment-consistent rotation, which the reference has no analog for.

All pairs in the batch share one padded length (a multiple of 1024), and
the comparison is only ever *within* a sequence (chosen vs alternatives
against the same reference), so the constant padding penalty cancels.
The whole batch is one launch on a CUDA device (the JAX package cut it
into chunks of at most 48 rows for the TPU's VMEM; each pair is
independent, so the scores do not depend on the cut).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional, Sequence, TextIO

import numpy as np

A_PAD = 8  # never matches B_PAD or any real code
B_PAD = 9


@dataclass
class RotationVerification:
    num_checked: int
    num_confirmed: int
    margins: np.ndarray  # (k-1,) chosen_score - best_alternative_score
    chosen_scores: np.ndarray

    @property
    def all_confirmed(self) -> bool:
        return self.num_confirmed == self.num_checked


def _bucket(n: int, q: int = 1024) -> int:
    return ((n + q - 1) // q) * q


def oracle_batch(encoded: Sequence[np.ndarray], rotations: Sequence[int],
                 samples: int = 8):
    """The (a, b) int32 batch of the oracle: for each sequence i >= 1, its
    chosen rotation then ``samples`` alternatives, each against sequence
    0's chosen rotation; rows padded to one 1024-multiple length."""
    k = len(encoded)
    n_pad = _bucket(max(len(e) for e in encoded))

    ref = np.full(n_pad, B_PAD, dtype=np.int32)
    r0 = np.roll(np.asarray(encoded[0]), -int(rotations[0]))
    ref[: len(r0)] = r0

    rows = []
    for i in range(1, k):
        e = np.asarray(encoded[i])
        n = len(e)
        cands = [int(rotations[i])]
        # alternatives spread deterministically away from the chosen pick
        for s in range(samples):
            cands.append((int(rotations[i]) + (s + 1) * n // (samples + 1)) % n)
        for c in cands:
            row = np.full(n_pad, A_PAD, dtype=np.int32)
            row[:n] = np.roll(e, -c)
            rows.append(row)
    a = np.stack(rows)
    return a, np.broadcast_to(ref, a.shape).copy()


def report(scores: np.ndarray, k: int, samples: int,
           log: TextIO) -> RotationVerification:
    """Margins of the chosen rotations from the (k-1) x (1+samples)
    scores, with the oracle's log lines."""
    scores = np.asarray(scores).reshape(k - 1, 1 + samples)
    chosen = scores[:, 0]
    best_alt = scores[:, 1:].max(axis=1)
    margins = chosen - best_alt
    confirmed = int((margins >= 0).sum())
    print(
        f"> Verifying rotations on device (pairwise NW oracle)... "
        f"{confirmed}/{k - 1} confirmed",
        file=log,
    )
    for i in range(k - 1):
        if margins[i] < 0:
            print(
                f">   WARNING sequence {i + 1}: an alternative rotation "
                f"outscores the chosen one by {-int(margins[i])}",
                file=log,
            )
    return RotationVerification(k - 1, confirmed, margins, chosen)


def verify_rotations(
    encoded: Sequence[np.ndarray],
    rotations: Sequence[int],
    *,
    device,
    samples: int = 8,
    log: Optional[TextIO] = None,
) -> RotationVerification:
    """Score chosen vs alternative rotations with the NW kernel on
    ``device`` (the plain version on the CPU).

    ``encoded``: original (un-rotated) code arrays; ``rotations``: the
    chain stage's picks.  Returns per-sequence margins; a negative margin
    means some sampled alternative rotation aligns better to the
    reference sequence than the chosen one.
    """
    from ..dp import nw

    log = log if log is not None else sys.stdout
    k = len(encoded)
    if k < 2:
        return RotationVerification(0, 0, np.zeros(0), np.zeros(0))
    a, b = oracle_batch(encoded, rotations, samples)
    scores = nw.pairwise_nw_scores(a, b, device).cpu().numpy()
    return report(scores, k, samples, log)
