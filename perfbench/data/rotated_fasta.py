"""Maker of a fixed set of sequences, each turned to a start drawn from
the run's seed: a GenBank record starts wherever its submitter chose,
and finding the rotation anyway is the aligner's purpose.  The FASTA
file ``params["file"]`` (beside this module) keeps its records' names
and order; each body is written on one line, rotated left by a start
drawn uniformly from ``[0, length)``.
"""

from __future__ import annotations

import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def read_records(path: str):
    """(name, body) of each record, the body's lines joined."""
    records = []
    with open(path) as f:
        for chunk in f.read().split(">")[1:]:
            head, _, body = chunk.partition("\n")
            records.append((head.rstrip("\r"),
                            "".join(body.split())))
    return records


def make(params: dict, seed: int, path: str) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for name, body in read_records(os.path.join(HERE, params["file"])):
            r = int(rng.integers(0, len(body)))
            f.write(f">{name}\n{body[r:] + body[:r]}\n")
