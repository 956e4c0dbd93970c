"""The plain reference reproduces the C tool's fixtures byte for byte:
``Primates-Rotated.fasta`` and the aligned rows of
``Primates-Rotated-Aligned.fasta`` from ``Primates.txt``, and every
``tiny/`` set's rotated and aligned FASTA.  On the benchmark's own
rotated inputs it writes what the JAX package writes, held here as
digests: Primates turned by two seeds, and the 8 x 1 Mbp set."""

import hashlib
import os
import shutil

import pytest

from conftest import FIX, ROOT
from perfbench import manifest
from perfbench.reference import pipeline

# sha256 of the JAX package's outputs for inputs that the benchmark's
# makers write, taken with
#   python -m csa_tpu.cli [R] set.txt --backend native
# on the CPU (the tests import nothing of that package)
WITNESS = {
    ("primates", 2**31 + 5, "N"): {
        "-Rotated.fasta": "b15bc63874ae302bec6b7483d605568d"
                          "7e413b06b80ff617c58a2fa9a0830e8f",
        "-Blocks.csv": "0b5a947958b14b2881c634f001cad5ac"
                       "cc90c2df072d0e7156425716a3bd68a3",
        "-positions.txt": "b277efef8933c4a7528cb744f9cb8cda"
                          "383e3487239fdbf2777c46e7a24723b6",
        "-imagemap.txt": "604273099f925d4adf1294cf7d48eae6"
                         "e82f10085779ac7de26e3f3cd5b56dd9",
        "-Blocks.bmp": "524e6c60e80169840bd78afc4a2cf505"
                       "fa003933895af6ffaa744ac8b8409700",
        "-Aligned.fasta": "85d73615c1ba64a7177446d8e10b2969"
                          "1b4e36571c2088522af934de68112115",
        "-CircularAlignment.bmp": "8d0a847a13e34b011781e9aafd416b85"
                                  "09aef1ca294a22df3061b19e4d2f52b3",
    },
    ("primates", 3 * 2**40 + 1, "R"): {
        "-Rotated.fasta": "9434bfb4a053850e2aea6c436c28bd36"
                          "b6a53374bd2b7308c793d15cc2449d4a",
        "-Blocks.csv": "f4ff5e53b81b3e30c59074562efe348c"
                       "42fbfcc85ebfdc0d16c1562d8016e5ab",
        "-positions.txt": "b277efef8933c4a7528cb744f9cb8cda"
                          "383e3487239fdbf2777c46e7a24723b6",
        "-imagemap.txt": "604273099f925d4adf1294cf7d48eae6"
                         "e82f10085779ac7de26e3f3cd5b56dd9",
        "-Blocks.bmp": "524e6c60e80169840bd78afc4a2cf505"
                       "fa003933895af6ffaa744ac8b8409700",
    },
}
# the JAX package's rotated FASTA of its baseline 8 x 1 Mbp set, seed 7
# (bench.py _mbp_set; chip_smoke.py MBP_FULL_SHA256, taken with its
# --backend native)
MBP_SEED_7_ROTATED = ("31e098ddd699cfff0df133e68936e5f6"
                      "e066b98bd366a5739ab8192ce7979759")

TINY = sorted(f[:-4] for f in os.listdir(os.path.join(FIX, "tiny"))
              if f.endswith(".txt"))


def _run(tmp_path, src, mode="N", **kw):
    path = str(tmp_path / os.path.basename(src))
    shutil.copy(src, path)
    pipeline.run(mode, path, **kw)
    return path[:-4]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", TINY)
def test_tiny_sets_byte_for_byte(tmp_path, name):
    base = _run(tmp_path, os.path.join(FIX, "tiny", name + ".txt"))
    for suffix in ("-Rotated.fasta", "-Aligned.fasta"):
        assert _read(base + suffix) == \
            _read(os.path.join(FIX, "tiny", name + suffix))


def test_primates_rotation_and_alignment(tmp_path):
    base = _run(tmp_path, os.path.join(FIX, "Primates.txt"))
    assert _read(base + "-Rotated.fasta") == \
        _read(os.path.join(FIX, "Primates-Rotated.fasta"))

    def rows(path):
        return [line for line in _read(path).decode().splitlines()
                if not line.startswith(">")]

    # the fixture was written by the C tool's mode A on the rotated file,
    # so only its headers differ from a full run's
    assert rows(base + "-Aligned.fasta") == \
        rows(os.path.join(FIX, "Primates-Rotated-Aligned.fasta"))
    written = set(os.listdir(tmp_path))
    assert {"Primates-Blocks.csv", "Primates-Blocks.bmp",
            "Primates-positions.txt", "Primates-imagemap.txt",
            "Primates-CircularAlignment.bmp"} <= written


def test_mode_r_writes_no_alignment(tmp_path):
    base = _run(tmp_path, os.path.join(FIX, "tiny", "t1.txt"), mode="R")
    assert os.path.exists(base + "-Rotated.fasta")
    assert not os.path.exists(base + "-Aligned.fasta")


def _sha256(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _made(tmp_path, config, seed):
    cfg = manifest.load_json(os.path.join(ROOT, "perfbench", "configs",
                                          config + ".json"))
    path = str(tmp_path / "set.txt")
    manifest.maker(cfg).make(cfg["params"], seed, path)
    return path


@pytest.mark.parametrize("config,seed,mode", sorted(WITNESS))
def test_rotated_inputs_as_the_jax_package_writes(tmp_path, config, seed,
                                                  mode):
    path = _made(tmp_path, config, seed)
    pipeline.run(mode, path)
    got = {name[len("set"):]: _sha256(str(tmp_path / name))
           for name in os.listdir(tmp_path) if name != "set.txt"}
    assert got == WITNESS[config, seed, mode]


@pytest.mark.slow
def test_mbp_rotation_as_the_jax_package_writes(tmp_path):
    # 8 x 1 Mbp: about 2 min and a few GiB on a CPU
    path = str(tmp_path / "mbp.txt")
    manifest.maker({"maker": "mbp_set"}).make(
        {"n": 1_000_000, "k": 8, "subst_per": 200}, 7, path)
    pipeline.run("R", path)
    assert _sha256(str(tmp_path / "mbp-Rotated.fasta")) == \
        MBP_SEED_7_ROTATED
