"""``correct`` comes out false for the control and for the faults a cell
can have.

The control is the plain reference with one guarantee of the
configuration broken, put in the program's place: equal-depth blocks in
reverse order (rotation cells), up winning a tie with diag in the gap DP
(alignment cells).  Each fault is planted in the program underneath a
whole run of the harness on the CPU: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced.  One cell has one chip, so no exchange between chips can be
left out."""

import os
import shutil

import numpy as np
import pytest

from conftest import FIX
from perfbench import outputs, run


@pytest.mark.parametrize("mode,control", [("R", "rotation_ties"),
                                          ("N", "dp_ties")])
def test_control_is_not_correct_on_primates(tmp_path, mode, control):
    src = os.path.join(FIX, "Primates.txt")
    want = run.reference_digests(mode, src, str(tmp_path))
    got = run.reference_digests(mode, src, str(tmp_path), control=control)
    wrong = outputs.wrong_jobs([got], want, mode)
    assert sum(wrong.values()) >= 1


def _unchanged_rotation(monkeypatch):
    from csa_tpu_torch.rotation import chains

    pick = chains.pick_rotations
    monkeypatch.setattr(chains, "pick_rotations",
                        lambda blocks: np.zeros_like(pick(blocks)))


def _half_the_sequences(monkeypatch):
    from csa_tpu_torch.io import fasta

    save = fasta.save_rotated

    def half(seqs, rotations, path):
        k = len(seqs) // 2
        sub = fasta.SequenceSet(names=seqs.names[:k], texts=seqs.texts[:k])
        return save(sub, rotations[:k], path)

    monkeypatch.setattr(fasta, "save_rotated", half)


def _altered_rotation(monkeypatch):
    from csa_tpu_torch.rotation import chains

    pick = chains.pick_rotations

    def altered(blocks):
        rot = pick(blocks).copy()
        rot[-1] += 1
        return rot

    monkeypatch.setattr(chains, "pick_rotations", altered)


def _unchanged_gap_columns(monkeypatch):
    from csa_tpu_torch.align import progressive

    monkeypatch.setattr(progressive, "delete_gapped_columns",
                        lambda usable, strings, numseqs, sv, consize, mx:
                        consize)


def _altered_dp_path(monkeypatch):
    from csa_tpu_torch.align import progressive

    to_maps = progressive._path_to_maps

    def altered(path):
        path = np.array(path, copy=True)
        turns = np.nonzero(path[:-1] != path[1:])[0]
        if len(turns):
            i = turns[0]
            path[i], path[i + 1] = path[i + 1], path[i]
        return to_maps(path)

    monkeypatch.setattr(progressive, "_path_to_maps", altered)


FAULTS = {
    "tiny.rotate": [_unchanged_rotation, _half_the_sequences,
                    _altered_rotation],
    "tiny.align": [_unchanged_gap_columns, _half_the_sequences,
                   _altered_dp_path],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_fault_underneath_is_not_correct(tiny_bench, monkeypatch, cell,
                                           fault):
    assert run.run_cell(cell, 21, 0.2, False, device="cpu",
                        root=tiny_bench)["correct"]
    fault(monkeypatch)
    result = run.run_cell(cell, 21, 0.2, False, device="cpu",
                          root=tiny_bench)
    assert not result["correct"]
    assert any(c["value"] > c["limit"] for c in result["checks"].values())


def test_a_fault_in_a_fresh_cli_process_is_not_correct(tiny_bench,
                                                       monkeypatch,
                                                       tmp_path):
    # the child imports this before the CLI module: the rotation's answer
    # is altered where it is produced
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "from csa_tpu_torch.rotation import chains\n"
        "_pick = chains.pick_rotations\n"
        "def _altered(blocks):\n"
        "    rot = _pick(blocks).copy()\n"
        "    rot[0] += 1\n"
        "    return rot\n"
        "chains.pick_rotations = _altered\n")
    monkeypatch.setenv("PYTHONPATH", str(site))
    result = run.run_cell("tiny.rotate_cli", 21, 0.2, False, device="cpu",
                          root=tiny_bench)
    assert not result["correct"]
    assert result["checks"]["rotated_fasta_wrong_jobs"]["value"] >= 1
