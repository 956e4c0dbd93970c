"""FASTA loading/writing with reference-parity semantics.

Mirrors the observable behavior of the reference loader
(``source/csamsa.c:433-519`` ``LoadSequences``) and the
rotated-FASTA writer (``csamsa.c:416-431`` ``saveRotatedSequences``):

* a sequence record starts at ``>``; the description is the rest of that line;
* sequence characters: ``ACGT`` (upper/lowercased) are kept, IUPAC ambiguity
  codes ``RYSWKMDHBVN`` (either case) are kept *as uppercase letters*,
  ``\\n \\r \\0 - `` and spaces are skipped, and any other character marks the
  record invalid (the record is dropped with a warning);
* empty records are dropped;
* at most ``MAX_SEQUENCES`` (64) sequences are loaded — the per-sequence
  bitmask design of the new engine keeps the same bound;
* fewer than 2 valid sequences is an error.

Matching in the engine happens over the *normalized* 5-letter alphabet
``{A, C, G, T, -}`` where every non-ACGT character collapses to ``-``
(reference: ``source/gencycsuffixtrees.c:321,332,346`` inside ``followChar``).
The original characters are preserved for output.
"""

from __future__ import annotations

import io as _io
import sys
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, TextIO

import numpy as np

MAX_SEQUENCES = 64  # reference: csamsa.c:23 MAXNUMBEROFSEQS (64-bit seq masks)

_ACGT = set("ACGT")
_IUPAC = set("RYSWKMDHBVN")

#: normalized alphabet order used by the whole engine: A=0 C=1 G=2 T=3 '-'=4
ALPHABET = "ACGT-"
ALPHABET_SIZE = 5

# Fast char-code lookup table: ASCII -> code in [0, 5); invalid chars -> -1.
_CODE_LUT = np.full(256, 4, dtype=np.int8)  # default: any byte -> '-'
for _i, _c in enumerate("ACGT"):
    _CODE_LUT[ord(_c)] = _i


@dataclass
class SequenceSet:
    """A loaded set of circular sequences.

    ``texts`` hold the original (validated, uppercased) characters;
    ``encoded`` holds the normalized 5-letter codes used for matching.
    """

    names: List[str] = field(default_factory=list)
    texts: List[str] = field(default_factory=list)

    def __len__(self) -> int:
        return len(self.texts)

    @property
    def sizes(self) -> List[int]:
        return [len(t) for t in self.texts]

    def encoded(self, i: int) -> np.ndarray:
        """Normalized codes (uint8 in [0,5)) of sequence ``i``."""
        raw = np.frombuffer(self.texts[i].encode("ascii"), dtype=np.uint8)
        return _CODE_LUT[raw].astype(np.uint8)

    def encoded_all(self) -> List[np.ndarray]:
        return [self.encoded(i) for i in range(len(self))]

    def drop(self, i: int) -> None:
        del self.names[i]
        del self.texts[i]


class FastaError(RuntimeError):
    pass


def _parse_record_body(body: str) -> Optional[str]:
    """Validate/normalize one record body; return None if invalid or empty.

    Reference semantics (csamsa.c:482-503): stop-and-drop on the first
    character outside the accepted set.
    """
    out = []
    for ch in body:
        if ch in "\n\r\0- ":
            continue
        up = ch.upper() if "a" <= ch <= "z" else ch
        if up in _ACGT or up in _IUPAC:
            out.append(up)
        else:
            return None  # invalid character -> whole record dropped
    if not out:
        return ""
    return "".join(out)


def load_fasta(
    path_or_file,
    *,
    max_sequences: int = MAX_SEQUENCES,
    log: Optional[TextIO] = None,
    min_sequences: int = 2,
) -> SequenceSet:
    """Load a multi-FASTA file of circular DNA sequences.

    Parity with reference ``LoadSequences`` (csamsa.c:433-519): invalid and
    empty records are skipped with a note, at most ``max_sequences`` records
    are loaded, and fewer than ``min_sequences`` valid records raises.
    """
    if hasattr(path_or_file, "read"):
        data = path_or_file.read()
    else:
        with open(path_or_file, "r", errors="replace") as f:
            data = f.read()
    log = log if log is not None else _io.StringIO()

    seqs = SequenceSet()
    start = data.find(">")
    if start < 0:
        raise FastaError("No sequences in file")
    chunks = data[start:].split(">")
    idx = 0
    for chunk in chunks:
        if not chunk:
            continue
        nl = len(chunk)
        for j, ch in enumerate(chunk):
            if ch in "\r\n":
                nl = j
                break
        desc = chunk[:nl]
        body = _parse_record_body(chunk[nl:])
        idx += 1
        shown = (desc[:40] + " " * max(0, 40 - len(desc)))[:40]
        if body is None:
            print(f"# {idx:02d} [{shown}] INVALID_CHARS", file=log)
            continue
        if body == "":
            print(f"# {idx:02d} [{shown}] EMPTY", file=log)
            continue
        print(f"# {idx:02d} [{shown}] OK ({len(body)} characters)", file=log)
        seqs.names.append(desc)
        seqs.texts.append(body)
        if len(seqs) == max_sequences:
            print(
                f"> WARNING: Current version only supports up to "
                f"{max_sequences} sequences",
                file=log,
            )
            break
    if len(seqs) < min_sequences:
        raise FastaError("Not enough valid sequences found")
    return seqs


def rotate_text(text: str, rot: int) -> str:
    return text[rot:] + text[:rot]


def save_rotated(
    seqs: SequenceSet, rotations: Sequence[int], path_or_file
) -> None:
    """Write ``>desc @ rot`` headers + rotated sequences.

    Parity with ``saveRotatedSequences`` (csamsa.c:416-431): one line per
    sequence, header records the rotation offset.
    """
    close = False
    if hasattr(path_or_file, "write"):
        f = path_or_file
    else:
        f = open(path_or_file, "w")
        close = True
    try:
        for name, text, rot in zip(seqs.names, seqs.texts, rotations):
            f.write(f">{name} @ {rot}\n")
            f.write(rotate_text(text, int(rot)))
            f.write("\n")
    finally:
        if close:
            f.close()


def parse_rotated_header(desc: str) -> tuple:
    """Parse a ``name @ rot`` header produced by :func:`save_rotated`."""
    if " @ " in desc:
        name, _, rot = desc.rpartition(" @ ")
        try:
            return name, int(rot)
        except ValueError:
            pass
    return desc, 0


def save_fasta(names: Sequence[str], texts: Sequence[str], path_or_file,
               width: int = 0) -> None:
    """Plain multi-FASTA writer (optionally wrapped at ``width`` columns)."""
    close = False
    if hasattr(path_or_file, "write"):
        f = path_or_file
    else:
        f = open(path_or_file, "w")
        close = True
    try:
        for name, text in zip(names, texts):
            f.write(f">{name}\n")
            if width and width > 0:
                for i in range(0, len(text), width):
                    f.write(text[i : i + width])
                    f.write("\n")
            else:
                f.write(text)
                f.write("\n")
    finally:
        if close:
            f.close()


def encode_text(text: str) -> np.ndarray:
    """Normalize arbitrary sequence text to 5-letter codes."""
    raw = np.frombuffer(text.encode("ascii", "replace"), dtype=np.uint8)
    return _CODE_LUT[raw].astype(np.uint8)


def is_rotation_of(a: np.ndarray, b: np.ndarray) -> Optional[int]:
    """If normalized sequence ``a`` equals some rotation of ``b``, return the
    rotation offset r such that rotate(b, r) == a, else None.

    Used for the duplicate-rotation discard
    (reference: gencycsuffixtrees.c:489-495).
    """
    if len(a) != len(b) or len(a) == 0:
        return None
    doubled = np.concatenate([b, b]).tobytes()
    pos = doubled.find(a.tobytes())
    if pos >= 0 and pos < len(b):
        return pos
    return None


def discard_duplicate_rotations(
    seqs: SequenceSet, log: Optional[TextIO] = None
) -> List[int]:
    """Drop sequences that are identical rotations of an earlier sequence.

    Mirrors the mid-build discard in the reference tree construction
    (gencycsuffixtrees.c:489-495 + discardSequence :373-389): the comparison
    happens over the *normalized* alphabet. Returns the original indices of
    the kept sequences.
    """
    log = log if log is not None else sys.stdout
    kept: List[int] = []
    kept_enc: List[np.ndarray] = []
    out_names: List[str] = []
    out_texts: List[str] = []
    for j in range(len(seqs)):
        enc = seqs.encoded(j)
        dup_of = None
        for i, prev in enumerate(kept_enc):
            if is_rotation_of(enc, prev) is not None:
                dup_of = kept[i]
                break
        if dup_of is not None:
            print(
                f"> WARNING: Discarding seq. {j + 1} because it is an "
                f"identical rotation of seq. {dup_of + 1}",
                file=log,
            )
            continue
        kept.append(j)
        kept_enc.append(enc)
        out_names.append(seqs.names[j])
        out_texts.append(seqs.texts[j])
    seqs.names = out_names
    seqs.texts = out_texts
    if len(seqs) < 2:
        raise FastaError("The program needs at least 2 sequences to run")
    return kept
