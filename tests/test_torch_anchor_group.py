"""The native grouping of the anchors' suffix entries into border nodes
(``native.anchor_group``, built into nodes by
``anchors._border_nodes_from_runs``) against its numpy twin
``anchors._group_border_nodes``, node for node: depth, per-sequence
positions and order.  Inputs are the repository's sets on the native
index and seeded entry arrays that reach the edges; the fallback without
the library and the ``numpy`` route take the twin."""

import io
import pathlib

import numpy as np
import pytest

from csa_tpu_torch import native
from csa_tpu_torch.align import anchors
from csa_tpu_torch.io import fasta as fio
from csa_tpu_torch.utils import PROFILER

FIX = pathlib.Path(__file__).resolve().parent / "fixtures"
SETS = ["Primates", "Mammals", "Set3"]
TINY = sorted(f"tiny/{p.stem}" for p in (FIX / "tiny").glob("*.txt"))


def _rotated(name):
    path = FIX / f"{name}-Rotated.fasta"
    return fio.load_fasta(str(path), log=io.StringIO()).encoded_all()


def _plain(nodes):
    return [(n.size, n.positions) for n in nodes]


def _native_nodes(idx, att, lb2):
    depths, offsets, positions, grouped = native.anchor_group(
        idx.seq_of, idx.pos_of, att, lb2, idx.num_seqs)
    return anchors._border_nodes_from_runs(depths, offsets, positions,
                                           idx.num_seqs), grouped


def _by_hand(idx, att, lb2):
    """The grouping's definition as a loop: the attached entries by
    (lb2, att) in that order, a group kept when it holds all k
    sequences, its positions by (seq, pos)."""
    groups = {}
    for x in np.flatnonzero(att >= 1):
        groups.setdefault((int(lb2[x]), int(att[x])), []).append(
            (int(idx.seq_of[x]), int(idx.pos_of[x])))
    nodes = []
    for (_, depth), members in sorted(groups.items()):
        runs = [sorted(p for s, p in members if s == j)
                for j in range(idx.num_seqs)]
        if all(runs):
            nodes.append((depth, runs))
    return nodes


def _assert_same(idx, att, lb2, twin=True):
    """The native nodes against the twin (``twin``) or the loop, and
    their types: a list of ints a sequence."""
    got, grouped = _native_nodes(idx, att, lb2)
    if twin:
        want = _plain(anchors._group_border_nodes(idx, att, lb2))
    else:
        want = _by_hand(idx, att, lb2)
    assert _plain(got) == want
    assert grouped == int(np.count_nonzero(att >= 1))
    for node in got:
        assert len(node.positions) == idx.num_seqs
        assert all(type(p) is list for p in node.positions)
        assert all(type(v) is int for p in node.positions for v in p)
    return got


@pytest.mark.parametrize("name", SETS + TINY)
def test_native_grouping_matches_the_twin_on_the_sets(name):
    idx = anchors.build_linear_index(_rotated(name), backend="native")
    att, lb2 = native.anchor_attach(idx.seq_of, idx.lcp, idx.cap,
                                    idx.num_seqs)
    nodes = _assert_same(idx, att, lb2)
    if name in SETS:
        assert len(nodes) > 1000


def _index(seq, pos, k):
    m = len(seq)
    zeros = np.zeros(m, dtype=np.int64)
    return anchors.LinearIndex(seq_of=np.asarray(seq, dtype=np.int64),
                               pos_of=np.asarray(pos, dtype=np.int64),
                               cap=zeros, lcp=zeros, num_seqs=k)


def _random_entries(seed, m, k, groups, depths):
    """``m`` entries of ``k`` sequences in ``groups`` interval starts and
    ``depths`` depths (att 0 = unattached), positions distinct per
    sequence, lb2 an entry index at or before its entry."""
    rng = np.random.default_rng(seed)
    seq = rng.integers(0, k, size=m)
    pos = np.empty(m, dtype=np.int64)
    for s in range(k):
        mine = np.flatnonzero(seq == s)
        pos[mine] = rng.permutation(4 * m)[: len(mine)]
    starts = np.sort(rng.choice(m, size=min(groups, m), replace=False))
    starts[0] = 0
    lb2 = starts[np.searchsorted(starts, np.arange(m), side="right") - 1]
    att = rng.integers(0, depths + 1, size=m)
    return _index(seq, pos, k), att.astype(np.int32), lb2.astype(np.int32)


@pytest.mark.parametrize("seed,m,k,groups,depths", [
    (0, 400, 4, 12, 3),
    (1, 2000, 8, 40, 2),
    (2, 3000, 16, 25, 4),
    (3, 50, 2, 5, 1),
    (4, 600, 2, 100, 6),
    (5, 5000, 64, 8, 2),
    (6, 3000, 64, 3, 1),
])
def test_native_grouping_matches_the_twin_on_random_entries(seed, m, k,
                                                             groups, depths):
    idx, att, lb2 = _random_entries(seed, m, k, groups, depths)
    nodes = _assert_same(idx, att, lb2)
    assert nodes, "no full group: the case reaches nothing"
    _assert_same(idx, att, lb2, twin=False)


def _edge(case):
    """(index, att, lb2, nodes the case must give)."""
    if case == "no_attached_entry":
        idx, _, lb2 = _random_entries(7, 300, 4, 10, 2)
        return idx, np.zeros(300, dtype=np.int32), lb2, 0
    if case == "single_entry":
        return (_index([0], [5], 1), np.array([3], np.int32),
                np.array([0], np.int32), 1)
    if case == "single_entry_of_two_sequences":
        return (_index([1], [5], 2), np.array([3], np.int32),
                np.array([0], np.int32), 0)
    if case in ("a_group_misses_one_sequence", "no_group_is_full"):
        # lb2 0: every sequence but 3 at depth 2; lb2 8: all four, or
        # all but 3 in the second case
        seq = [0, 1, 2, 0, 1, 2, 0, 1] + [3, 2, 1, 0, 3]
        pos = [9, 4, 7, 1, 8, 2, 5, 6] + [3, 11, 12, 13, 0]
        att = [2] * 8 + [5] * 5
        lb2 = [0] * 8 + [8] * 5
        if case == "no_group_is_full":
            seq = seq[:8] + [2, 2, 1, 0, 0]
        return (_index(seq, pos, 4), np.array(att, np.int32),
                np.array(lb2, np.int32), int(case != "no_group_is_full"))
    if case == "many_occurrences_in_one_sequence":
        # one (lb2, att) group, sequence 1 six times with its positions
        # out of order, and a deeper group of the same lb2
        seq = [1, 0, 1, 1, 1, 2, 1, 1, 0, 2]
        pos = [50, 3, 10, 40, 20, 7, 30, 0, 1, 2]
        att = [4, 4, 4, 4, 4, 4, 4, 4, 9, 9]
        return (_index(seq, pos, 3), np.array(att, np.int32),
                np.zeros(10, np.int32), 1)
    raise ValueError(case)


@pytest.mark.parametrize("case", [
    "no_attached_entry", "single_entry", "single_entry_of_two_sequences",
    "a_group_misses_one_sequence", "no_group_is_full",
    "many_occurrences_in_one_sequence"])
def test_native_grouping_matches_the_twin_at_the_edges(case):
    idx, att, lb2, want = _edge(case)
    # where entries are attached but no group is full, the twin (like
    # csa_tpu's) raises IndexError: there the loop is the reference
    has_twin = want > 0 or not np.any(att >= 1)
    nodes = _assert_same(idx, att, lb2, twin=has_twin)
    _assert_same(idx, att, lb2, twin=False)
    assert len(nodes) == want
    if case == "many_occurrences_in_one_sequence":
        assert nodes[0].positions == [[3], [0, 10, 20, 30, 40, 50], [7]]


def _count_twin_calls(monkeypatch):
    calls = []
    twin = anchors._group_border_nodes

    def counted(*args):
        calls.append(1)
        return twin(*args)

    monkeypatch.setattr(anchors, "_group_border_nodes", counted)
    return calls


@pytest.mark.parametrize("name", ["tiny/t3", "tiny/a-repeat-1"])
def test_without_the_library_the_twin_groups(monkeypatch, name):
    enc = _rotated(name)
    want = _plain(anchors.compute_border_nodes(enc, backend="native"))
    calls = _count_twin_calls(monkeypatch)
    monkeypatch.setattr(native, "_load", lambda: None)
    assert native.anchor_group(np.zeros(1), np.zeros(1), np.ones(1),
                               np.zeros(1), 1) is None
    got = _plain(anchors.compute_border_nodes(enc, backend="native"))
    assert calls and got == want


def test_the_numpy_route_groups_with_the_twin(monkeypatch):
    enc = _rotated("tiny/a-diverge-1")
    want = _plain(anchors.compute_border_nodes(enc, backend="native"))
    calls = _count_twin_calls(monkeypatch)

    def refuse(*args):
        raise AssertionError("the numpy route called the native grouping")

    monkeypatch.setattr(native, "anchor_group", refuse)
    got = _plain(anchors.compute_border_nodes(enc, backend="numpy"))
    assert calls and got == want


@pytest.mark.parametrize("route", ["native", "numpy"])
def test_the_grouping_counts_its_entries_and_nodes(route):
    enc = _rotated("tiny/t3")
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        nodes = anchors.compute_border_nodes(enc, backend=route)
        counters = dict(PROFILER.counters)
        out = io.StringIO()
        PROFILER.report(out)
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    idx = anchors.build_linear_index(enc, backend="native")
    att, _ = native.anchor_attach(idx.seq_of, idx.lcp, idx.cap,
                                  idx.num_seqs)
    assert counters["anchors.grouped_entries"] == np.count_nonzero(att >= 1)
    assert counters["anchors.border_nodes"] == len(nodes) > 0
    assert "anchors.grouped_entries" in out.getvalue()
    assert "anchors.border_nodes" in out.getvalue()


@pytest.mark.parametrize("bad", ["lb2_past_the_end", "seq_past_k",
                                 "short_pos"])
def test_native_grouping_refuses_entries_out_of_range(bad):
    idx, att, lb2 = _random_entries(8, 100, 4, 5, 2)
    seq, pos = idx.seq_of.copy(), idx.pos_of
    if bad == "lb2_past_the_end":
        lb2 = lb2.copy()
        lb2[-1] = 100
    elif bad == "seq_past_k":
        seq[3] = 4
    else:
        pos = pos[:-1]
    with pytest.raises(ValueError):
        native.anchor_group(seq, pos, att, lb2, 4)
