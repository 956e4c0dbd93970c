"""One short run of a cell on the card, as the runner starts it (marker
``cuda``: it skips where there is no card, decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

from conftest import ROOT


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card only")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "primates.rotate",
         "--seed", str(2**31 + 3), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"


def test_without_a_card_the_run_gives_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "primates.rotate",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and not proc.stdout.strip()
