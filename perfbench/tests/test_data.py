"""The data makers: the same seed gives the same bytes, other seeds
other inputs of the same sizes; the Mbp maker is the JAX package's
baseline set, as ``chip_smoke.py`` writes it."""

import os
import sys

import pytest

from conftest import ROOT
from perfbench import manifest

SEEDS = [7, 2**31 + 5, 3 * 2**40 + 1]


def _config(name):
    return manifest.load_json(os.path.join(ROOT, "perfbench", "configs",
                                           name + ".json"))


# the JAX package's baseline Mbp set (bench.py, _mbp_set)
MBP = {"maker": "mbp_set", "params": {"n": 1_000_000, "k": 8,
                                      "subst_per": 200}}


def _make(config, seed, path, **params):
    cfg = MBP if config == "mbp" else _config(config)
    manifest.maker(cfg).make(dict(cfg["params"], **params), seed, path)
    with open(path, "rb") as f:
        return f.read()


def _records(data):
    out = []
    for chunk in data.decode().split(">")[1:]:
        name, _, body = chunk.partition("\n")
        out.append((name, body.strip()))
    return out


@pytest.mark.parametrize("config,params", [("primates", {}),
                                           ("mbp", {"n": 20_000})])
def test_same_seed_same_bytes_other_seed_other_input(tmp_path, config,
                                                     params):
    runs = [_make(config, s, str(tmp_path / f"{i}.txt"), **params)
            for i, s in enumerate(SEEDS + SEEDS[:1])]
    assert runs[0] == runs[-1]
    assert len({r for r in runs[:-1]}) == len(SEEDS)
    lengths = {tuple(len(b) for _, b in _records(r)) for r in runs}
    assert len(lengths) == 1


def test_primates_maker_turns_each_record(tmp_path):
    from perfbench.data import rotated_fasta

    want = rotated_fasta.read_records(os.path.join(ROOT, "perfbench", "data",
                                                   "Primates.txt"))
    got = _records(_make("primates", 11, str(tmp_path / "p.txt")))
    assert [n for n, _ in got] == [n for n, _ in want]
    assert sum(len(b) for _, b in want) == 265_297
    for (_, b), (_, w) in zip(got, want):
        assert len(b) == len(w) and b in w + w


def test_primates_copy_is_the_fixture():
    with open(os.path.join(ROOT, "perfbench", "data", "Primates.txt"),
              "rb") as f, \
            open(os.path.join(ROOT, "tests", "fixtures", "Primates.txt"),
                 "rb") as g:
        assert f.read() == g.read()


@pytest.mark.parametrize("n,k,seed", [(2_000, 4, 7), (20_000, 8, 13)])
def test_mbp_maker_is_the_baseline_set(tmp_path, n, k, seed):
    sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke._write_mbp(tmp_path / "want.txt", n=n, k=k, seed=seed)
    got = _make("mbp", seed, str(tmp_path / "got.txt"), n=n, k=k)
    assert got == (tmp_path / "want.txt").read_bytes()
