"""FASTA/alignment utilities: clean, integrity check, SP score, MSF.

Behavioral equivalents of ``source/tools.c``:
``CleanDNAFastaFile`` :12-120, ``TestAlignmentFileOutput`` :123-191,
``CalculateSumOfPairsScore`` :194-293, ``ConvertFastaToMsf`` :431-553.
Console output mirrors the reference's messages; numeric results are
bit-identical (integer scores/counts).
"""

from __future__ import annotations

import os
import sys
from typing import Optional, TextIO

import numpy as np

_VALID = set(b"ACGT")
_LOWER = set(b"acgt")
_BLANK = set(b"\n\r\0 ")
_IUPAC = set(b"RYSWKMDHBVN" + b"ryswkmdhbvn")


def clean_fasta(path: str, *, log: Optional[TextIO] = None) -> str:
    """``C`` mode: strip non-ACGT characters, uppercase, one line per seq.

    Writes ``Clean-<basename>`` next to the working directory (the
    reference prefixes the whole path string; we prefix the basename so
    the output lands in the current directory like the reference run from
    the input's directory).
    """
    log = log if log is not None else sys.stdout
    print(f"> Loading sequences from file <{path}> ... ", end="", file=log)
    try:
        size = os.path.getsize(path)
    except OSError:
        print("\n> ERROR: Sequence file not found", file=log)
        return ""
    print(f"({size} bytes)", file=log)
    data = open(path, "rb").read()
    if not data.startswith(b">"):
        print("> ERROR: Invalid FASTA file", file=log)
        return ""
    head, _, tail = path.rpartition("/")
    outname = (head + "/" if head else "") + "Clean-" + tail
    out = open(outname, "wb")
    pos = 1
    nseqs = 0
    while True:
        out.write(b">")
        desc_start = pos
        while pos < len(data) and data[pos] not in b"\n\r":
            pos += 1
        desc = data[desc_start:pos]
        out.write(desc + b"\n")
        shown = desc[:20].decode("ascii", "replace")
        nvalid = ninvalid = nspecial = nextra = seqlen = 0
        while pos < len(data):
            c = data[pos]
            if c == ord(">"):
                break
            pos += 1
            if c in b"\n\r":
                # the reference counts the newline right after the
                # description inside the sequence loop too
                seqlen += 1
                nspecial += 1
                continue
            seqlen += 1
            if c in _VALID:
                out.write(bytes([c]))
                nvalid += 1
            elif c in _LOWER:
                out.write(bytes([c - 32]))
                nvalid += 1
            elif c in _BLANK:
                nspecial += 1
            elif c in _IUPAC:
                nextra += 1
            else:
                ninvalid += 1
        out.write(b"\n")
        print(
            f"  [{shown:<20}] ({seqlen} chars: {nvalid}V {nspecial}S "
            f"{nextra}X {ninvalid}I)",
            file=log,
        )
        nseqs += 1
        if pos >= len(data):
            break
        pos += 1  # skip '>'
    out.close()
    print(f"> {nseqs} sequence(s) processed", file=log)
    print(
        f"> Saving sequences to file <{outname}> ... "
        f"({os.path.getsize(outname)} bytes)",
        file=log,
    )
    return outname


def _read_alignment(path: str):
    """Parse an aligned multi-FASTA into (descs, rows of bytes)."""
    descs = []
    rows = []
    cur = []
    for raw in open(path, "rb").read().split(b"\n"):
        if raw.startswith(b">"):
            if cur:
                rows.append(b"".join(cur))
                cur = []
            descs.append(raw[1:].decode("ascii", "replace").rstrip("\r"))
        else:
            cur.append(raw.strip(b"\r"))
    if cur:
        rows.append(b"".join(cur))
    return descs, rows


def test_alignment_output(
    original_path: str, aligned_path: str, *, log: Optional[TextIO] = None
) -> bool:
    """Integrity check (tools.c:123-191): the aligned strings, with gaps
    removed, must equal the original sequences character for character."""
    log = log if log is not None else sys.stdout
    print("> Checking integrity of aligned sequences... ", end="", file=log)
    _, rows1 = _read_alignment(original_path)
    _, rows2 = _read_alignment(aligned_path)
    if len(rows1) != len(rows2):
        print(
            f"ERROR at: sequence counts differ "
            f"({len(rows1)} vs {len(rows2)})",
            file=log,
        )
        return False
    for i, (r1, r2) in enumerate(zip(rows1, rows2)):
        s1 = r1.replace(b"-", b"")
        s2 = r2.replace(b"-", b"")
        if s1 != s2:
            n = min(len(s1), len(s2))
            a1 = np.frombuffer(s1[:n], dtype=np.uint8)
            a2 = np.frombuffer(s2[:n], dtype=np.uint8)
            diffs = np.nonzero(a1 != a2)[0]
            at = int(diffs[0]) if len(diffs) else n
            c1 = chr(s1[at]) if at < len(s1) else "$"
            c2 = chr(s2[at]) if at < len(s2) else "$"
            print(
                f"ERROR at: '{c1}'@[{i + 1}:{at}]=!='{c2}'@[{i + 1}:{at}]",
                file=log,
            )
            return False
    print("OK", file=log)
    return True


def sum_of_pairs_score(path: str, *, log: Optional[TextIO] = None) -> int:
    """``S`` mode (tools.c:194-293): SP score + stats of an alignment."""
    log = log if log is not None else sys.stdout
    print(f"> Opening file <{path}> ... ", end="", file=log)
    try:
        size = os.path.getsize(path)
    except OSError:
        print("\n> ERROR: Sequence file not found", file=log)
        return -1
    print(f"({size} bytes)", file=log)
    _, rows = _read_alignment(path)
    k = len(rows)
    if k < 2:
        print("> ERROR: Not enough sequences in file", file=log)
        return -1
    sizes = {len(r) for r in rows}
    if len(sizes) != 1:
        print("> ERROR: Consensus sizes are not consistent", file=log)
        return -1
    n = len(rows[0])
    mat = np.stack([np.frombuffer(r, dtype=np.uint8) for r in rows])  # (k, n)
    counts = np.zeros((5, n), dtype=np.int64)
    for ci, ch in enumerate(b"ACGT-"):
        counts[ci] = (mat == ch).sum(axis=0)
    ngaps = int(counts[4].sum())
    conserved = int((np.max(counts, axis=0) == k).sum())
    # pairs: match +1 per same-char pair; gap-gap 0; everything else -1
    same_char = (counts[:4] * (counts[:4] - 1) // 2).sum(axis=0)
    gap_gap = counts[4] * (counts[4] - 1) // 2
    total_pairs = k * (k - 1) // 2
    mismatch = total_pairs - same_char - gap_gap
    score = int((same_char - mismatch).sum())
    print(f"> {k} sequence(s) processed", file=log)
    print(
        "> Statistics:\n"
        f"Consensus size = {n}\n"
        f"Average gaps per sequence = {ngaps // k}\n"
        f"Number of conserved columns = {conserved}\n"
        f"Sum-of-Pairs score = {score}",
        file=log,
    )
    return score


def fasta_to_msf(path: str, *, log: Optional[TextIO] = None) -> str:
    """``M`` mode (tools.c:431-553): aligned FASTA -> MSF."""
    log = log if log is not None else sys.stdout
    print(f"> Opening FASTA file <{path}>... ", end="", file=log)
    base, dot, _ = path.rpartition(".")
    if not dot:
        base = path
    msfname = base + ".msf"
    descs, rows = _read_alignment(path)
    if not rows:
        print("> ERROR: No sequences found in FASTA file", file=log)
        return ""
    sizes = {len(r) for r in rows}
    if len(sizes) != 1:
        print("> ERROR: Sequences alignment sizes do not match", file=log)
        return ""
    alen = len(rows[0])
    # 10-char names with spaces removed (tools.c:481-488)
    names = ["".join(d.split())[:10] for d in descs]
    print(f"({len(rows)} aligned sequences of size {alen})", file=log)
    print(f"> Saving alignments to MSF file <{msfname}>... ", end="", file=log)
    with open(msfname, "w") as f:
        f.write("!!NA_MULTIPLE_ALIGNMENT 1.0\n\n")
        f.write(f" {msfname} \tMSF: {alen} \tType: N \tCheck: 0 \t..\n\n")
        for nm, r in zip(names, rows):
            f.write(
                f" Name: {nm} oo\tLen: {len(r)} \tCheck: 0 \tWeight: 1.00 \n"
            )
        f.write("\n//\n\n")
        n = 0
        while n < alen:
            for nm, r in zip(names, rows):
                f.write(f"{nm} \t")
                m = n
                for i in range(5):
                    chunk = r[m : m + 10].decode("ascii").replace("-", ".")
                    f.write(chunk)
                    m += len(chunk)
                    if m >= alen:
                        break
                    # the reference emits the column separator after every
                    # complete block, including the fifth (tools.c:533)
                    f.write(" ")
                f.write("\n")
            n += 50
            f.write("\n")
    print("OK", file=log)
    return msfname
