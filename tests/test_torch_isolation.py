"""The port stands alone: no file of csa_tpu_torch, and not chip_smoke.py,
imports the JAX package or JAX, and the port's CLI runs every mode in a
process where both are refused at import."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
SOURCES = sorted(
    str(p.relative_to(REPO))
    for p in [*(REPO / "csa_tpu_torch").rglob("*.py"), REPO / "chip_smoke.py"]
)
FORBIDDEN = ("csa_tpu", "jax", "jaxlib")

# installed first in the child process: importing a forbidden root raises
BLOCKER = """
import importlib.abc, sys
class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("refused import of " + name)
sys.meta_path.insert(0, _Refuse())
""" % (FORBIDDEN,)


def _imported_roots(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]


@pytest.mark.parametrize("rel", SOURCES)
def test_source_imports_nothing_of_jax_or_csa_tpu(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    bad = sorted(set(_imported_roots(tree)) & set(FORBIDDEN))
    assert not bad, f"{rel} imports {bad}"


def _run_blocked(code: str, cwd) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    return subprocess.run([sys.executable, "-c", BLOCKER + code], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_every_port_module_imports_with_jax_refused(tmp_path):
    mods = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(
            ".__init__")
        for p in (REPO / "csa_tpu_torch").rglob("*.py")
        if p.name != "__main__.py"
    )
    code = ("import importlib\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "import sys\n"
            f"assert not [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n")
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("mode", ["N", "R", "I", "C", "S", "M", "sharded"])
def test_cli_mode_runs_with_jax_refused(mode, tmp_path):
    """Each mode of the port's CLI on a tiny set, on the CPU, in a process
    that refuses csa_tpu and jax.  S and M read the aligned file that mode
    N writes first; I draws the Mammals alignment fixture (the tiny sets
    are too short for the plot); "sharded" is mode N with --backend
    sharded on a CPU mesh of 2 ranks."""
    (tmp_path / "t1.txt").write_bytes((FIX / "tiny" / "t1.txt").read_bytes())
    runs = [["t1.txt", "--device", "cpu"]]
    if mode == "sharded":
        runs = [["t1.txt", "--device", "cpu", "--backend", "sharded",
                 "--mesh", "2x1"]]
    elif mode == "R":
        runs = [["R", "t1.txt", "--device", "cpu", "--verify-rotations"]]
    elif mode == "C":
        runs = [["C", "t1.txt"]]
    elif mode == "I":
        aln = "Mammals-Rotated-Aligned.fasta"
        (tmp_path / aln).write_bytes((FIX / aln).read_bytes())
        runs = [["I", aln]]
    elif mode != "N":
        runs.append([mode, "t1-Aligned.fasta"])
    code = "from csa_tpu_torch import cli\n" + "".join(
        f"assert cli.main({argv!r}) == 0\n" for argv in runs)
    proc = _run_blocked(code, tmp_path)
    assert proc.returncode == 0, proc.stderr
    expect = {"N": "t1-Aligned.fasta", "sharded": "t1-Aligned.fasta",
              "R": "t1-Rotated.fasta",
              "I": "Mammals-Rotated-Aligned-CircularAlignment.bmp",
              "C": "Clean-t1.txt", "S": None, "M": "t1-Aligned.msf"}[mode]
    if expect:
        assert (tmp_path / expect).stat().st_size > 0, sorted(
            p.name for p in tmp_path.iterdir())
    if mode == "R":
        assert "pairwise NW oracle" in proc.stdout
    if mode == "S":
        assert "score" in proc.stdout.lower()
