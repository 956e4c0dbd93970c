"""Nothing the benchmark runs imports JAX or the JAX package, and the
plain reference imports nothing of the program either.  Top-level module
names are compared whole: ``csa_tpu_torch`` begins with ``csa_tpu``."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "perfbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "csa_tpu"}


def _sources(top):
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _imported(path):
    """Top-level names of every module a file imports (absolute)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_or_jax_package(path):
    assert not _imported(path) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted(_sources(os.path.join(BENCH, "reference"))),
    ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_nothing_of_the_program(path):
    assert not _imported(path) & (FORBIDDEN | {"csa_tpu_torch", "torch"})


def test_the_check_compares_whole_names():
    from perfbench import run

    assert "csa_tpu" in run.FORBIDDEN
    assert not {"csa_tpu_torch"} & set(run.FORBIDDEN)
