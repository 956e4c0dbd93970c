"""The port's whole slice on the CPU: the CLI (modes N and R) against the
reference fixtures and against the JAX package run with
``backend="jax"`` under the same configuration (each package's own
RunConfig installed), plus the port's guards (no JAX import, no silent
CPU run, no build without nvcc)."""

import csv
import io
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from csa_tpu import config
from csa_tpu.align import runner as jrunner
from csa_tpu.io import fasta as fio
from csa_tpu.rotation import pipeline as jrot
from csa_tpu_torch import cli, kernels
from csa_tpu_torch import config as tconfig
from csa_tpu_torch.align import runner
from csa_tpu_torch.config import from_jax_config, scoring_kwargs
from csa_tpu_torch.rotation import pipeline as rot

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
TINY = sorted(p.stem for p in (FIX / "tiny").glob("*.txt"))


def _run_cli(tmp_path, monkeypatch, src, *argv):
    (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.chdir(tmp_path)
    assert cli.main([*argv, src.name, "--device", "cpu"]) == 0
    return tmp_path / src.stem


@pytest.mark.parametrize("name", TINY)
def test_cli_full_pipeline_matches_fixtures(name, tmp_path, monkeypatch):
    out = _run_cli(tmp_path, monkeypatch, FIX / "tiny" / f"{name}.txt")
    ref = FIX / "tiny" / name
    assert (out.parent / f"{name}-Rotated.fasta").read_bytes() == \
        pathlib.Path(f"{ref}-Rotated.fasta").read_bytes()
    assert (out.parent / f"{name}-Aligned.fasta").read_bytes() == \
        pathlib.Path(f"{ref}-Aligned.fasta").read_bytes()


def _port_config(cfg) -> tconfig.RunConfig:
    """The port's own RunConfig with the fields of a JAX-package one."""
    return tconfig.RunConfig(
        scoring=tconfig.Scoring(*cfg.scoring.as_tuple()),
        min_block_size=cfg.min_block_size,
        max_block_size=cfg.max_block_size,
        max_interval=cfg.max_interval, pack_w=cfg.pack_w)


def _both_packages(name, cfg, tmp_path):
    """Rotate + align ``name`` with csa_tpu (backend jax) and the port
    (device cpu), each under its own package's config built from
    ``cfg``; returns the two aligned files."""
    seqs = fio.load_fasta(str(FIX / "tiny" / f"{name}.txt"),
                          log=io.StringIO())
    kw = from_jax_config(cfg)
    outs = []
    config.set_run_config(cfg)
    tconfig.set_run_config(_port_config(cfg))
    try:
        for tag in ("jax", "torch"):
            if tag == "jax":
                res = jrot.analyze(seqs, backend="jax", cfg=cfg,
                                   log=io.StringIO())
            else:
                res = rot.analyze(seqs, device="cpu", pack_w=kw["pack_w"],
                                  max_interval=kw["max_interval"],
                                  log=io.StringIO())
            codes = [np.roll(e, -int(r))
                     for e, r in zip(seqs.encoded_all(), res.rotations)]
            if tag == "jax":
                result = jrunner.run_alignment(codes, dp_backend="jax",
                                               log=io.StringIO())
            else:
                result = runner.run_alignment(codes, device="cpu",
                                              log=io.StringIO(),
                                              **scoring_kwargs(kw))
            out = tmp_path / f"{name}-{tag}.fasta"
            save = jrunner.save_alignment if tag == "jax" else \
                runner.save_alignment
            save(str(out), result, codes, seqs.names, res.rotations,
                 log=io.StringIO())
            outs.append(out.read_bytes())
    finally:
        config.set_run_config(config.RunConfig())
        tconfig.set_run_config(tconfig.RunConfig())
    return outs


@pytest.mark.parametrize("name", ["t1", "a-diverge-0", "a-homo-1"])
def test_port_matches_jax_backend_default_config(name, tmp_path):
    want, got = _both_packages(name, config.RunConfig(), tmp_path)
    assert got == want
    assert got == (FIX / "tiny" / f"{name}-Aligned.fasta").read_bytes()


@pytest.mark.parametrize("name", ["t3", "a-gc-1"])
def test_port_matches_jax_backend_non_default_scoring(name, tmp_path):
    cfg = config.RunConfig(scoring=config.Scoring(
        match=3, mismatch=-2, indel=-4, doublegap=-1))
    want, got = _both_packages(name, cfg, tmp_path)
    assert got == want


def _csv_rows(path):
    with open(path) as f:
        reader = csv.reader(f)
        next(reader)
        return {(row[1], tuple(row[2:])) for row in reader}


def test_cli_rotation_primates_matches_fixtures(tmp_path, monkeypatch):
    out = _run_cli(tmp_path, monkeypatch, FIX / "Primates.txt", "R")
    assert (tmp_path / "Primates-Rotated.fasta").read_bytes() == \
        (FIX / "Primates-Rotated.fasta").read_bytes()
    assert _csv_rows(f"{out}-Blocks.csv") == \
        _csv_rows(FIX / "Primates-Blocks.csv")


def test_cli_profile_and_trace(tmp_path, monkeypatch, capsys):
    """--profile prints the phase breakdown; CSA_TPU_TORCH_TRACE writes a
    torch.profiler Chrome trace."""
    from csa_tpu_torch.utils import PROFILER

    monkeypatch.setenv("CSA_TPU_TORCH_TRACE", str(tmp_path / "trace"))
    try:
        _run_cli(tmp_path, monkeypatch, FIX / "tiny" / "t1.txt", "--profile")
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    out = capsys.readouterr().out
    assert "rot.block_stage[torch]" in out and "align.dp_fill" in out
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0


def test_cli_imports_no_jax(tmp_path):
    (tmp_path / "t1.txt").write_bytes((FIX / "tiny" / "t1.txt").read_bytes())
    code = ("import sys\n"
            "from csa_tpu_torch import cli\n"
            "assert cli.main(['t1.txt', '--device', 'cpu']) == 0\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert (tmp_path / "t1-Aligned.fasta").read_bytes() == \
        (FIX / "tiny" / "t1-Aligned.fasta").read_bytes()


@pytest.mark.parametrize("mode", [[], ["R"], ["A"]], ids=["N", "R", "A"])
def test_cli_cuda_without_device_exits_nonzero(mode, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "t1.txt").write_bytes((FIX / "tiny" / "t1.txt").read_bytes())
    monkeypatch.chdir(tmp_path)
    with pytest.raises(SystemExit) as exc:
        cli.main([*mode, "t1.txt"])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)
    assert not (tmp_path / "t1-Rotated.fasta").exists()


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_find_nvcc", lambda: None)
    with pytest.raises(kernels.KernelBuildError, match="nvcc not found"):
        kernels.build()


def test_kernel_build_raises_when_nvcc_fails(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: refused' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "_find_nvcc", lambda: str(fake))
    with pytest.raises(kernels.KernelBuildError, match="refused"):
        kernels.build()
    assert not list((tmp_path / "_build").glob("*.so"))


def test_library_name_follows_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    before = kernels.library_path()
    (src / "a.cu").write_text("// two\n")
    assert kernels.library_path() != before


def test_library_name_follows_header_hash(tmp_path, monkeypatch):
    """An edit of a header that the sources include (``csrc/*.cuh``)
    names a new library, so a stale one is never loaded."""
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "a.cu").write_text('#include "e.cuh"\n')
    (src / "e.cuh").write_text("// one\n")
    monkeypatch.setattr(kernels, "CSRC", src)
    before = kernels.library_path()
    (src / "e.cuh").write_text("// two\n")
    assert kernels.library_path() != before
    assert kernels.sources() == [src / "a.cu"]
