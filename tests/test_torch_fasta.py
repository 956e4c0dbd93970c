"""The port's FASTA loader (``csa_tpu_torch.io.fasta.load_fasta``), which
parses its input as one byte buffer, against the JAX package's loader,
which parses decoded text a character at a time: the same names, texts
and log on seeded generated inputs read from a path, a binary stream and
a text stream; its first call in a fresh process imports no module; and
its two counters in a ``--profile`` report."""

import contextlib
import io
import json
import os
import pathlib
import random
import subprocess
import sys

import pytest

from csa_tpu.io import fasta as jfio
from csa_tpu_torch import cli
from csa_tpu_torch.io import fasta as fio
from csa_tpu_torch.utils import PROFILER

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
PRIMATES = REPO / "perfbench" / "data" / "Primates.txt"

ACGT = "ACGT"
IUPAC = "RYSWKMDHBVN"


def _body(rng, n, alphabet=ACGT):
    return "".join(rng.choice(alphabet) for _ in range(n))


def _record(rng, name, body, eol="\n", final=True):
    """``>name`` and ``body`` in lines of 20-70 characters."""
    lines, i = [], 0
    while i < len(body):
        w = rng.randint(20, 70)
        lines.append(body[i:i + w])
        i += w
    text = ">" + name + eol + eol.join(lines)
    return text + eol if final else text


def _records(rng, n, eol="\n", alphabet=ACGT, size=(40, 300)):
    return "".join(_record(rng, f"seq{i} {_body(rng, 5, 'xyz_.')}",
                           _body(rng, rng.randint(*size), alphabet), eol)
                   for i in range(n))


def _spoil(rng, records: str, bad: str) -> str:
    """``records`` with ``bad`` put inside one body line."""
    lines = records.split("\n")
    at = rng.choice([i for i, ln in enumerate(lines)
                     if ln and not ln.startswith(">")])
    ln = lines[at]
    cut = rng.randint(0, len(ln))
    lines[at] = ln[:cut] + bad + ln[cut:]
    return "\n".join(lines)


def _mixed(rng):
    alphabet = ACGT + ACGT.lower() + IUPAC + IUPAC.lower() + "NNn-- \0"
    return _records(rng, 5, alphabet=alphabet).encode()


def _invalid(bad):
    def make(rng):
        return _spoil(rng, _records(rng, 4), bad).encode()
    return make


def _ff_body(rng):
    good = _records(rng, 4).encode()
    cut = good.index(b"\n", good.index(b">seq2")) + 3
    return good[:cut] + b"\xff" + good[cut:]


def _ff_header(rng):
    return b">bad \xff name\n" + _body(rng, 80).encode() + b"\n" + \
        _records(rng, 3).encode()


def _empty_records(rng):
    return ("junk before the first record\nACGT\n"
            + _records(rng, 2)
            + ">header only, no body\n"
            + ">\n"
            + ">>" + _record(rng, "after an empty chunk", _body(rng, 50))
            + ">spaces and gaps only\n  --\n\0\n"
            + _records(rng, 1)
            + ">last header, no line end").encode()


def _gt_midline(rng):
    return (_record(rng, "a", _body(rng, 60)) + "ACGTACGT>mid line name\n"
            + _body(rng, 70) + "\n" + _records(rng, 2)).encode()


def _no_final_newline(rng):
    return (_records(rng, 3)
            + _record(rng, "last", _body(rng, 90), final=False)).encode()


def _seventy(rng):
    return _records(rng, 70, size=(10, 40)).encode()


def _too_few(rng):
    return (_records(rng, 1) + _spoil(rng, _records(rng, 1), "X")
            + ">empty\n").encode()


def _no_record(rng):
    return (_body(rng, 100) + "\n").encode()


CASES = {
    "mixed_case_iupac_gaps_nul": _mixed,
    "crlf": lambda rng: _records(rng, 4, "\r\n", ACGT + "acgtn").encode(),
    "lone_cr": lambda rng: _records(rng, 4, "\r", ACGT + "ryn-").encode(),
    "invalid_x": _invalid("X"),
    "invalid_lower_x": _invalid("x"),
    "invalid_digit": _invalid("7"),
    "invalid_tab": _invalid("\t"),
    "invalid_utf8": _invalid("é"),
    "invalid_ff_in_body": _ff_body,
    "ff_in_header": _ff_header,
    "empty_header_only_and_junk": _empty_records,
    "gt_in_mid_line": _gt_midline,
    "no_final_newline": _no_final_newline,
    "seventy_records": _seventy,
    "too_few_valid": _too_few,
    "no_record": _no_record,
    "primates": lambda rng: PRIMATES.read_bytes(),
}


def _load(loader, source):
    """(names, texts) or the error, and the log, of one load."""
    log = io.StringIO()
    try:
        seqs = loader(source, log=log)
        got = (seqs.names, seqs.texts)
    except (fio.FastaError, jfio.FastaError) as e:
        got = ("FastaError", str(e))
    return got, log.getvalue()


@pytest.mark.parametrize("source", ["path", "binary", "text"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_load_fasta_matches_the_jax_loader(case, source, tmp_path):
    seed = sorted(CASES).index(case) + 1801
    path = tmp_path / "in.txt"
    path.write_bytes(CASES[case](random.Random(seed)))
    want = _load(jfio.load_fasta, str(path))
    if source == "path":
        got = _load(fio.load_fasta, str(path))
    elif source == "binary":
        got = _load(fio.load_fasta, io.BytesIO(path.read_bytes()))
    else:
        with open(path, "r", errors="replace") as f:
            got = _load(fio.load_fasta, io.StringIO(f.read()))
    assert got == want
    if case == "seventy_records":
        assert len(want[0][0]) == fio.MAX_SEQUENCES
        assert "supports up to 64 sequences" in want[1]
    if case in ("too_few_valid", "no_record"):
        assert want[0][0] == "FastaError"
    if case.startswith("invalid_"):
        assert "INVALID_CHARS" in want[1]


FRESH = """
import io, json, sys
from csa_tpu_torch.io import fasta
path = sys.argv[1]
with open(path, "rb") as f:
    raw = f.read()
text = raw.decode()
before = set(sys.modules)
fasta.load_fasta(path, log=io.StringIO())
fasta.load_fasta(io.BytesIO(raw), log=io.StringIO())
fasta.load_fasta(io.StringIO(text), log=io.StringIO())
print(json.dumps(sorted(set(sys.modules) - before)))
"""


def test_a_fresh_process_first_load_imports_no_module(tmp_path):
    src = tmp_path / "in.txt"
    src.write_bytes(_mixed(random.Random(5)))
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", FRESH, str(src)],
                          cwd=tmp_path, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.splitlines()[-1]) == []


def test_profile_counts_the_bytes_and_the_dropped_records(tmp_path,
                                                          monkeypatch):
    src = tmp_path / "t1.txt"
    src.write_bytes((FIX / "tiny" / "t1.txt").read_bytes()
                    + b">invalid\nACGTXACGT\n>empty\n\n")
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    PROFILER.reset()
    try:
        with contextlib.redirect_stdout(out):
            assert cli.main(["R", src.name, "--device", "cpu",
                             "--profile"]) == 0
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    lines = out.getvalue().splitlines()
    assert f"> [profile] io.fasta_bytes: {src.stat().st_size}" in lines
    assert "> [profile] io.fasta_records_dropped: 2" in lines
    assert any(ln.endswith("[invalid" + " " * 33 + "] INVALID_CHARS")
               for ln in lines)
    assert any(ln.endswith("[empty" + " " * 35 + "] EMPTY") for ln in lines)
