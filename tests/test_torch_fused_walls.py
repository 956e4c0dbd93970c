"""The fresh-process measurement of the fused and staged routes
(csa_tpu_torch.index.fused_walls) on the CPU, small: each route's child
times its calls, the routes' outputs agree, and the CLI's runs read
their ``--profile`` phases."""

import pytest

from csa_tpu_torch.index import fused_walls


def test_call_walls_time_every_route_and_agree():
    res = fused_walls.measure(sets=[("tiny/t1",)],
                              routes=("staged", "fused", "eager"),
                              device="cpu", reps=1, calls=2, cli_runs=[])
    per = res["calls"][res["roots"][0]]["tiny/t1"]
    assert set(per) == {"staged", "fused", "eager"}
    for route, (child,) in per.items():
        assert len(child["block_ms"]) == len(child["linear_ms"]) == 2
        # the staged route runs no fused program; the others one a call
        want = [0, 0] if route == "staged" else [1, 1]
        assert child["block_programs"] == child["linear_programs"] == want
        assert child["captures"] == child["replays"] == 0   # the CPU


def test_cli_walls_read_the_profile_and_agree():
    res = fused_walls.measure(sets=[], device="cpu", reps=1, cli_runs=[
        ("R", ("tiny/t1",), ["staged", "native"])])
    per = res["cli"][res["roots"][0]]["R tiny/t1"]
    assert "rot.block_stage[torch]" in per["staged"][0]["phases"]
    assert "rot.block_stage[native]" in per["native"][0]["phases"]
    assert all(r[0]["wall_s"] > 0 for r in per.values())


def test_turns_alternate():
    assert fused_walls._turns([1, 2], 3) == [1, 2, 2, 1, 1, 2]


def test_differing_outputs_raise(monkeypatch):
    """A route whose output differs from the others' fails the run."""
    real = fused_walls._child
    seen = []

    def child(root, code, args, cwd, timeout):
        text, wall = real(root, code, args, cwd, timeout)
        seen.append(1)
        if len(seen) == 2:
            text = text.replace('"block_digest": "', '"block_digest": "x')
        return text, wall

    monkeypatch.setattr(fused_walls, "_child", child)
    with pytest.raises(AssertionError):
        fused_walls.measure(sets=[("tiny/t1",)], routes=("staged", "eager"),
                            device="cpu", reps=1, calls=1, cli_runs=[])
