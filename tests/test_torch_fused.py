"""The port's fused routes (csa_tpu_torch.index.engine) against the JAX
package's single-dispatch programs on the CPU: the fused block stage's
packed vector element for element against ``_fused_small_program`` at
the same static parameters, its host loop's retries from small starts
and from the guesses a staged call records, the duplicate-rotation
branch, ``rotation_final``'s route (staged at a key's first call, the
fused program on a card after it), the linear twin against
``_linear_index_device_et``, and the linear sort's ``FUSED_MAX_CHARS``
gate with its environment override.  Integer outputs, exact."""

import functools
import io
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from csa_tpu.index import engine as jengine
from csa_tpu.io import fasta as fio
from csa_tpu_torch import kernels
from csa_tpu_torch.index import engine, graphs
from csa_tpu_torch.parallel.sharded import make_mesh
from csa_tpu_torch.utils import PROFILER

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

REPO = pathlib.Path(__file__).resolve().parent.parent
FIX = REPO / "tests" / "fixtures"
DUP_SET = [np.array([0, 1, 2, 3] * 6), np.array([1, 2, 3, 0] * 6)]


def _circular_set(k, n, seed, noise=40):
    """k rotated, mutated copies of one random base (shared blocks)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    enc = []
    for _ in range(k):
        row = np.roll(base, int(rng.integers(0, n))).copy()
        idx = rng.integers(0, n, size=max(1, n // noise))
        row[idx] = rng.integers(0, 4, size=len(idx))
        enc.append(row[: n - int(rng.integers(0, 30))])
    return enc


def _encoded(name):
    if name.startswith("seed"):
        return _circular_set(4, 1500, int(name[4:]))
    seqs = fio.load_fasta(str(FIX / f"{name}.txt"), log=io.StringIO())
    return seqs.encoded_all()


@pytest.fixture(autouse=True)
def gate_open(monkeypatch):
    """The linear sort's fused gate above every set here (its default,
    0, turns the route off); the tests of the gate set it themselves."""
    monkeypatch.setattr(engine, "FUSED_MAX_CHARS", 1 << 62)


@pytest.fixture
def on_card(monkeypatch):
    """rotation_final's check for a CUDA device stubbed to pass: its
    fused route runs here, graphs.run running the program eagerly."""
    monkeypatch.setattr(engine, "_on_card", lambda device: True)


@pytest.fixture
def staged_calls(monkeypatch):
    """A list that grows by one at each rotation_final_staged call."""
    seen = []
    real = engine.rotation_final_staged
    monkeypatch.setattr(engine, "rotation_final_staged",
                        lambda *a, **kw: seen.append(1) or real(*a, **kw))
    return seen


@pytest.fixture
def fresh_caches(monkeypatch):
    """Empty guess caches for the test, restored after."""
    for name in ("_TDEEP_CACHE", "_CAPS_CACHE", "_LEVELS_CACHE",
                 "_LINEAR_LEVELS_CACHE"):
        monkeypatch.setattr(engine, name, {})


@pytest.fixture
def runs(monkeypatch):
    """The static keys of every program run through graphs.run."""
    seen = []
    real = graphs.run

    def spy(key, program, inputs, device):
        seen.append(key)
        return real(key, program, inputs, device)

    monkeypatch.setattr(graphs, "run", spy)
    return seen


def _program_args(enc):
    codes, lengths = engine._fused_inputs(enc)
    k, n_max = codes.shape
    return codes, lengths, k, n_max


# (set, tdeep, cap, ecap, fcap): csa_tpu's first guesses, and tight caps
# whose counts overflow (the vector reports them the same way)
PROGRAM_CASES = [
    ("tiny/t1", 7, 4096, 1 << 16, 1024),
    ("tiny/t8", 2, 16, 64, 8),
    ("tiny/a-repeat-0", 7, 4096, 1 << 15, 1024),
    ("Primates", 7, 4096, 1 << 17, 1024),
    ("seed1", 3, 64, 256, 16),
    ("seed2", 7, 4096, 1 << 15, 1024),
]


@pytest.mark.parametrize("name,tdeep,cap,ecap,fcap", PROGRAM_CASES)
def test_fused_program_vector_matches_jax(name, tdeep, cap, ecap, fcap):
    enc = _encoded(name)
    codes, lengths, k, n_max = _program_args(enc)
    lmax = jengine._num_levels(n_max)
    assert engine._num_levels(n_max, 12) == lmax
    want = np.asarray(jengine._fused_small_program(
        jnp.asarray(codes.numpy()), jnp.asarray(lengths.numpy(), jnp.int32),
        k=k, n_max=n_max, Lmax=lmax, tdeep=tdeep, cap=cap, ecap=ecap,
        fcap=fcap))
    # the refinement count the data needs, and the static bound
    for levels in (engine.LEVELS_START, lmax - 1):
        got = engine._fused_block_program(
            codes, lengths, k=k, n_max=n_max, pack_w=12, levels=levels,
            tdeep=tdeep, cap=cap, ecap=ecap, fcap=fcap).numpy()
        assert got[-1] == 0   # no tie left: the guess was enough
        np.testing.assert_array_equal(got[:-1], want)


def test_fused_program_duplicate_flag_matches_jax():
    codes, lengths, k, n_max = _program_args(DUP_SET)
    lmax = jengine._num_levels(n_max)
    # csa_tpu's first guesses for this set, so rotation_final_jax below
    # reuses the compiled program
    kw = dict(k=k, n_max=n_max, tdeep=7, cap=4096, ecap=1 << 14, fcap=1024)
    want = np.asarray(jengine._fused_small_program(
        jnp.asarray(codes.numpy()), jnp.asarray(lengths.numpy(), jnp.int32),
        Lmax=lmax, **kw))
    got = engine._fused_block_program(codes, lengths, pack_w=12,
                                      levels=lmax - 1, **kw).numpy()
    assert want[0] == 1
    np.testing.assert_array_equal(got[:-1], want)


@functools.lru_cache(maxsize=None)
def _jax_final(name):
    return jengine.rotation_final_jax(_encoded(name))


def _same_final(got, want):
    assert got.num_collected == want.num_collected
    assert got.num_after_suffix == want.num_after_suffix
    np.testing.assert_array_equal(got.final_start, want.final_start)
    np.testing.assert_array_equal(got.final_depth, want.final_depth)
    np.testing.assert_array_equal(got.final_positions, want.final_positions)


@pytest.mark.parametrize("name", ["tiny/t8", "tiny/a-repeat-0", "Primates"])
def test_rotation_final_fused_matches_jax_and_staged(name, fresh_caches,
                                                     runs, on_card):
    """A key's first rotation_final call is staged; the second runs the
    fused program once; both equal the JAX package's result."""
    enc = _encoded(name)
    want = _jax_final(name)
    kernels.reset_counts()
    _same_final(engine.rotation_final(enc, "cpu"), want)
    assert not runs
    got = engine.rotation_final(enc, "cpu")
    assert len(runs) == 1 and runs[0][0] == "block"
    assert set(kernels.COUNTS.values()) == {0}
    _same_final(got, want)
    _same_final(engine.rotation_final_staged(enc, "cpu"), want)


@pytest.mark.parametrize("name", ["Primates", "seed1", "seed2"])
def test_staged_call_primes_one_fused_run(name, fresh_caches, runs):
    """The guesses a staged call records let the key's first fused run
    pass every check of the loop: one program, no retry (Primates
    overflows csa_tpu's own first ``ecap`` guess without them), equal to
    the staged result and to csa_tpu's."""
    enc = _encoded(name)
    staged = engine.rotation_final_staged(enc, "cpu")
    key = tuple(engine._fused_inputs(enc)[0].shape)
    assert key in engine._LEVELS_CACHE and key in engine._TDEEP_CACHE
    assert key in engine._CAPS_CACHE
    got = engine._rotation_final_fused(enc, "cpu")
    assert len(runs) == 1
    _same_final(got, staged)
    _same_final(got, _jax_final(name))


@pytest.mark.parametrize("where", ["card", "mesh", "cpu"])
def test_rotation_final_replays_a_key_it_has_run(where, fresh_caches, runs,
                                                 staged_calls, request):
    """On a card the first call of a key is staged and each later call
    runs the fused program; with a mesh, or on the CPU, every call is
    staged."""
    if where != "cpu":
        request.getfixturevalue("on_card")
    mesh = make_mesh(2, devices=[torch.device("cpu")]) \
        if where == "mesh" else None
    enc = _encoded("tiny/t1")
    for _ in range(3):
        _same_final(engine.rotation_final(enc, "cpu", mesh=mesh),
                    _jax_final("tiny/t1"))
    fused = 2 if where == "card" else 0
    assert (len(runs), len(staged_calls)) == (fused, 3 - fused)


def test_rotation_final_fused_duplicates_return_none(fresh_caches):
    assert jengine.rotation_final_jax(DUP_SET) is None
    assert engine._rotation_final_fused(DUP_SET, "cpu") is None
    assert engine.rotation_final(DUP_SET, "cpu") is None


# the fields of a block program's static key after "block", k, n_max,
# pack_w; what is forced small -> (set, its field, which must grow)
LEVELS, TDEEP, CAP, ECAP, FCAP = range(4, 9)
RETRIES = {
    "levels": ("tiny/a-repeat-0", LEVELS),
    "tdeep": ("tiny/a-repeat-0", TDEEP),
    "cap": ("tiny/a-repeat-0", CAP),
    "ecap": ("Primates", ECAP),
    "fcap": ("tiny/a-repeat-0", FCAP),
}


@pytest.mark.parametrize("what", sorted(RETRIES))
def test_fused_retries_from_a_small_start(what, fresh_caches, runs,
                                          monkeypatch):
    """Each guess forced to 1 (``ecap``: Primates overflows csa_tpu's own
    first guess) retries with a new static key and ends at csa_tpu's
    result; the cache then holds the guess that worked."""
    name, field = RETRIES[what]
    enc = _encoded(name)
    key = tuple(engine._fused_inputs(enc)[0].shape)
    cap = 4096
    if what == "levels":
        engine._LEVELS_CACHE[key] = 1
    elif what == "tdeep":
        engine._TDEEP_CACHE[key] = 1
    elif what == "cap":
        cap = 1
    elif what == "fcap":
        monkeypatch.setattr(engine, "FCAP_MIN", 1)
    got = engine._rotation_final_fused(enc, "cpu", cap=cap)
    _same_final(got, _jax_final(name))
    assert len(runs) >= 2
    assert runs[-1][field] > runs[0][field]
    assert len({r[field] for r in runs}) == len(runs)
    if what == "levels":
        assert engine._LEVELS_CACHE[key] == runs[-1][field]
    del runs[:]
    _same_final(engine._rotation_final_fused(enc, "cpu", cap=cap),
                _jax_final(name))
    assert len(runs) == 1   # the cached guesses hold: one run


def test_fused_level_guess_misses_and_is_retried(fresh_caches, runs):
    """A first refinement guess below the count the data needs: the
    program reports ties, the host retries larger until none remain."""
    enc = _encoded("seed3")
    key = tuple(engine._fused_inputs(enc)[0].shape)
    engine._LEVELS_CACHE[key] = 1
    got = engine._rotation_final_fused(enc, "cpu")
    _same_final(got, jengine.rotation_final_jax(enc))
    levels = [r[LEVELS] for r in runs]
    assert levels[0] == 1 and levels == sorted(levels) and len(levels) > 1
    assert engine._LEVELS_CACHE[key] == levels[-1]


def _group_stats_input(rng, n):
    newgrp = rng.random(n) < 0.3
    newgrp[0] = True
    return torch.from_numpy(newgrp), torch.arange(n)


@pytest.mark.parametrize("n", [1, 2, 7, 1000])
def test_group_stats_static_matches_scans(n):
    """The group stats (a cumsum and a table of group starts) against
    the two running scans they replace: the group start by a running
    max of the starts, the next group's start by a reversed running min,
    and the counts from their difference."""
    rng = np.random.default_rng(n)
    newgrp, g = _group_stats_input(rng, n)
    ng, gi = newgrp.numpy(), g.numpy()
    start = np.maximum.accumulate(np.where(ng, gi, 0))
    nxt = np.minimum.accumulate(np.where(ng, gi, n)[::-1])[::-1]
    size = np.append(nxt[1:], n) - start
    got = engine._group_stats(newgrp, g)
    np.testing.assert_array_equal(got[0].numpy(), start)
    assert (int(got[1]), int(got[2])) == (int((size > 1).sum()),
                                          int(size.max()))


def _linear_string(seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 6))
    parts = []
    for i in range(k):
        body = rng.integers(0, 4 if seed % 2 else 2,
                            size=int(rng.integers(100, 700)))
        parts += [body + k, [i]]
    return np.concatenate(parts).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_linear_twin_matches_jax(seed, fresh_caches, runs, monkeypatch):
    s = _linear_string(seed)
    n = len(s)
    total = jengine._bucket(max(n, 8))
    levels = jengine._linear_levels(total)
    sp = np.zeros(total, dtype=np.int32)
    sp[:n] = s
    wsa, wlcp = (np.asarray(x) for x in jengine._linear_index_device_et(
        jnp.asarray(sp), jnp.int32(n), total=total, levels=levels))
    got = engine._linear_fused_program(
        torch.from_numpy(sp.astype(np.int64)), torch.tensor(n),
        levels=levels, steps=levels - 1).numpy()
    assert got[0] == 0
    np.testing.assert_array_equal(got[1:total + 1], wsa)
    np.testing.assert_array_equal(got[total + 1:], wlcp)
    # the route, from a guess that misses, and the staged loop
    want = jengine.linear_suffix_order(s)
    monkeypatch.setattr(engine, "LINEAR_LEVELS_START", 1)
    for got in (engine.linear_suffix_order(s, "cpu"),
                engine.linear_suffix_order(s, "cpu")):
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    steps = [key[2] for key in runs]
    assert steps[0] == 1 and steps[-2] == steps[-1] > 1
    monkeypatch.setattr(engine, "FUSED_MAX_CHARS", 0)
    got = engine.linear_suffix_order(s, "cpu")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("side", ["at", "above"])
def test_fused_gate_on_the_padded_size(side, fresh_caches, runs,
                                       staged_calls, on_card, monkeypatch):
    """rotation_final replays a key it has run up to REPLAY_MAX_CHARS
    padded characters (k * _bucket(max len)), linear_suffix_order takes
    the fused route up to FUSED_MAX_CHARS of padded string; above, the
    staged routes."""
    enc = _encoded("tiny/t1")
    padded = len(enc) * engine._bucket(max(len(e) for e in enc))
    gate = padded if side == "at" else padded - 1
    monkeypatch.setattr(engine, "REPLAY_MAX_CHARS", gate)
    monkeypatch.setattr(engine, "FUSED_MAX_CHARS", gate)
    for _ in range(2):
        got = engine.rotation_final(enc, "cpu")
        _same_final(got, jengine.rotation_final_jax(enc))
    assert (len(runs), len(staged_calls)) == \
        ((1, 1) if side == "at" else (0, 2))
    # a linear string of the padded size
    s = np.random.default_rng(0).integers(1, 5, size=padded)
    del runs[:]
    engine.linear_suffix_order(s, "cpu")
    assert len(runs) == (1 if side == "at" else 0)


def test_fused_gate_env_override():
    """CSA_TPU_FUSED_MAX_CHARS sets the linear sort's gate at import;
    the block stage's replay limit does not read it."""
    code = ("from csa_tpu_torch.index import engine; "
            "print(engine.FUSED_MAX_CHARS, engine.REPLAY_MAX_CHARS)")
    env = {**os.environ, "PYTHONPATH": str(REPO),
           "CSA_TPU_FUSED_MAX_CHARS": "12345"}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    assert out.split() == ["12345", "1605632"]


def test_fused_route_profile_phase_and_plain_run(fresh_caches):
    """On the CPU the program runs eagerly through graphs.run (no graph,
    no capture, no replay) inside the ``idx.fused`` phase, and its one
    download counts as the stage's one device read."""
    before = dict(graphs.STATS)
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        engine._rotation_final_fused(_encoded("tiny/t1"), "cpu")
        phases = dict(PROFILER.phases)
        counters = dict(PROFILER.counters)
    finally:
        PROFILER.enabled = False
        PROFILER.reset()
    assert "idx.fused" in phases
    assert counters["idx.device_reads"] == 1
    assert "graph_replays" not in counters
    assert "graph_captures" not in counters
    assert graphs.STATS == before
    with pytest.raises(ValueError):
        graphs.run(("x",), lambda t: t, (torch.zeros(1),), "meta")
