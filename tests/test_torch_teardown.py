"""The teardown loop (csa_tpu_torch.parallel.teardown) on the CPU: a real
pair of processes forms two worlds, agrees and tears down with every
process exiting 0, no thread of a world left and its group freed; the
loop's counts of aborted and failed worlds from made-up process results;
its summary line; and its entry point asking for the card.  Each spawned
pair has a deadline and free ports."""

import json
import sys

import pytest
import torch

from csa_tpu_torch.parallel import distributed, sharded, teardown

TIMEOUT = 240


def test_teardown_loop_on_the_cpu():
    """Two worlds in one pair of processes (a second world after a
    shutdown in the same process): no abort, no failure; each world ran
    over gloo, freed its group and left no thread behind in either
    process (a gloo worker thread alive at interpreter exit aborted the
    process); the pair's start and exit are recorded."""
    res = teardown.run_teardown_loop(2, device="cpu", worlds_per_process=2,
                                     timeout=TIMEOUT)
    assert (res["worlds"], res["aborts"], res["failed"]) == (2, 0, 0), res
    for rec in res["records"]:
        assert rec["ok"] and rec["exit_codes"] == [0, 0]
        assert rec["backend"] == "gloo"
        assert rec["group_freed"] is True
        assert rec["threads_left"] == [0, 0]
        assert len(rec["shutdown_ms"]) == len(rec["init_ms"]) == 2
    assert res["records"][0]["start_s"] > 0
    assert res["records"][0]["exit_s"] >= 0
    line = teardown.summary_line(res)
    assert line.startswith("summary teardown worlds=2 aborts=0 wall_s=")
    assert "shutdown_ms_median=" in line and "exit_s_median=" in line


def _want():
    return teardown.exchanges(sharded.Ranks(sharded.make_mesh(
        4, (4, 1), devices=[torch.device("cpu")])))


def _world_line(pid, exchanges, moved=96):
    return teardown.WORLD_TAG + json.dumps({
        "exchanges": exchanges, "local": [2 * pid, 2 * pid + 1],
        "rank_process_bytes": moved, "backend": "gloo", "init_ms": 5.0,
        "exchange_ms": 9.0, "shutdown_ms": 1.0, "group_freed": True,
        "threads_left": 0})


def _own(want, pid):
    """What process pid of two prints for the exchanges ``want``."""
    mine = (2 * pid, 2 * pid + 1)
    return {k: v if k in ("gather_to_first", "item")
            else [x if r in mine else None for r, x in enumerate(v)]
            for k, v in want.items()}


def test_loop_counts_aborts_and_failures_of_ranks_worlds(monkeypatch):
    """A process killed by SIGABRT after a correct world is an abort (and
    a failure); a process whose exchanges differ from one process's is a
    failure only; a pair past its deadline fails every world it held."""
    want = _want()
    bad = json.loads(json.dumps(_own(want, 1)))
    bad["ring"][2] = [0] * 6
    runs = iter([
        [(0, _world_line(0, _own(want, 0)), ""),
         (-6, _world_line(1, _own(want, 1)), "terminate called")],
        [(0, _world_line(0, _own(want, 0)), ""),
         (0, _world_line(1, bad), "")],
        [(0, _world_line(0, _own(want, 0)), ""),
         (0, _world_line(1, _own(want, 1)), "")],
        TimeoutError("2 processes ran over 1 s"),
    ])

    def fake(argvs, **kw):
        out = next(runs)
        if isinstance(out, Exception):
            raise out
        return out

    monkeypatch.setattr(distributed, "run_processes", fake)
    res = teardown.run_teardown_loop(4, device="cpu")
    assert res["aborted_worlds"] == [0]
    assert res["failed_worlds"] == [0, 1, 3]
    assert (res["aborts"], res["failed"]) == (1, 3)
    assert "terminate called" in res["records"][0]["error"]


def test_summary_line_takes_the_medians():
    """The breakdown's medians over every process's world and every
    pair; a key no world recorded is left out."""
    recs = [{"shutdown_ms": [1.0, 3.0], "init_ms": [10.0, 12.0],
             "threads_left": [0, 0], "start_s": 8.0, "exit_s": 0.25},
            {"shutdown_ms": [2.0, 5.0], "init_ms": [11.0, 30.0],
             "threads_left": [0, 1]}]
    line = teardown.summary_line({"worlds": 2, "aborts": 0, "failed": 0,
                                  "wall_s": 20.5, "device": "cpu",
                                  "records": recs})
    assert line == ("summary teardown worlds=2 aborts=0 wall_s=20.500 "
                    "failed=0 device=cpu start_s_median=8.000 "
                    "init_ms_median=12.000 shutdown_ms_median=3.000 "
                    "exit_s_median=0.250 threads_left_max=1")


@pytest.mark.filterwarnings("ignore:.*found in sys.modules:RuntimeWarning")
@pytest.mark.parametrize("argv", [[], ["--device", "cuda"]],
                         ids=["default", "cuda"])
def test_teardown_main_asks_for_the_card(monkeypatch, argv):
    """``python -m csa_tpu_torch.parallel.teardown`` runs on the card
    unless asked for the CPU: with no CUDA device it raises before it
    spawns a process."""
    import runpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spawned = []
    monkeypatch.setattr(distributed, "run_processes",
                        lambda *a, **k: spawned.append(a))
    monkeypatch.setattr(sys, "argv", ["teardown", *argv])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runpy.run_module("csa_tpu_torch.parallel.teardown",
                         run_name="__main__")
    assert not spawned
