"""A job's output files, by digest, against the plain reference's.

The CLI writes its outputs beside its input, named from the input's base
name and a suffix (``cli.py``'s ``*_SUFFIX``); a job's outputs are keyed
by suffix, so jobs and the reference can use any base name.  Each
output belongs to the layer that produced it.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List

# suffix -> kind, the layers whose output the window times
KINDS = {
    "-Rotated.fasta": "rotated_fasta",
    "-positions.txt": "blocks",
    "-Blocks.csv": "blocks",
    "-imagemap.txt": "blocks",
    "-Blocks.bmp": "blocks",
    "-Aligned.fasta": "aligned_fasta",
    "-CircularAlignment.bmp": "plot",
}
MODE_KINDS = {"R": ["rotated_fasta", "blocks"],
              "N": ["rotated_fasta", "blocks", "aligned_fasta", "plot"]}


def digests(directory: str, input_name: str) -> Dict[str, str]:
    """sha256 of every file in ``directory`` but the input, keyed by the
    part of its name after the input's base name."""
    base = input_name.rpartition(".")[0] or input_name
    out = {}
    for name in sorted(os.listdir(directory)):
        path = os.path.join(directory, name)
        if name == input_name or not os.path.isfile(path):
            continue
        key = name[len(base):] if name.startswith(base) else name
        h = hashlib.sha256()
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
        out[key] = h.hexdigest()
    return out


def kind_of(suffix: str) -> str:
    return KINDS.get(suffix, "other")


def wrong_jobs(jobs: List[Dict[str, str]], want: Dict[str, str],
               mode: str) -> Dict[str, int]:
    """Per kind of output, the number of jobs whose files of that kind
    differ from ``want`` (a file missing or extra counts); ``other``
    counts jobs that wrote a file no layer of the mode writes."""
    counts = {kind: 0 for kind in MODE_KINDS[mode] + ["other"]}
    for got in jobs:
        bad = {kind_of(s) for s in set(got) | set(want)
               if got.get(s) != want.get(s)}
        for kind in bad:
            counts[kind if kind in counts else "other"] += 1
    return counts
