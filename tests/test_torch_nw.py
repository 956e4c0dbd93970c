"""The port's pairwise NW (csa_tpu_torch.dp.nw) and rotation-verification
oracle (csa_tpu_torch.rotation.verification) against the JAX package on
the CPU: the Pallas kernel in interpret mode, the native host scores,
and the JAX oracle's numbers and log text."""

import io

import numpy as np
import pytest
import torch

from csa_tpu import cli as jcli
from csa_tpu.dp import pallas_nw
from csa_tpu.rotation import verification as jverification
from csa_tpu_torch import cli, kernels
from csa_tpu_torch.dp import nw
from csa_tpu_torch.rotation import verification

import torch_jax_native

torch.set_num_threads(1)
# the JAX package's native library, loaded under an inter-process lock
torch_jax_native.ensure()

SHAPES = [(3, 40, 55), (2, 100, 100), (2, 131, 62), (1, 1, 7), (2, 7, 1)]


def _pairs(B, la, lb):
    rng = np.random.default_rng(la * 1000 + lb)
    return rng.integers(0, 4, size=(B, la)), rng.integers(0, 4, size=(B, lb))


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_pallas_interpret_and_host(shape):
    a, b = _pairs(*shape)
    got = nw.pairwise_nw_scores_plain(torch.from_numpy(a).int(),
                                      torch.from_numpy(b).int())
    assert got.dtype == torch.int32 and got.shape == (shape[0],)
    want = pallas_nw.pairwise_nw_scores(a, b, interpret=True)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), nw.nw_scores_host(a, b))
    np.testing.assert_array_equal(got.numpy(), pallas_nw.nw_scores_host(a, b))


def test_cpu_tensor_takes_plain_version():
    a, b = _pairs(2, 50, 33)
    kernels.reset_counts()
    got = nw.pairwise_nw_scores(a, b, "cpu")
    assert kernels.COUNTS["nw"] == 0
    assert got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), nw.nw_scores_host(a, b))


def test_unsupported_device_raises():
    a, b = _pairs(1, 5, 5)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        nw.pairwise_nw_scores(a, b, "meta")


@pytest.mark.parametrize("la", [1, 31, 4096, 4097, 17_408, 20_480, 20_481,
                                45_000])
def test_plan_covers_rows(la):
    """The kernel's launch plan: the fewest bands of at most one warp's
    rows (LANES x S) that cover la, of nearly equal height, each a
    multiple of S but the last, which is not empty."""
    S, h, nb = nw.plan(la)
    assert S == nw.STRIP and h % S == 0 and S <= h <= nw.LANES * S
    assert (nb - 1) * h < la <= nb * h
    assert nb == -(-la // (nw.LANES * S))
    assert h < la / nb + 2 * S


def _band_twin(a, b, *, strip, chunk, resident, seed):
    """A numpy twin of csrc/nw.cu's band pipeline, in W = H + i + j form.

    The bands of ``plan(la, strip)`` are tickets, band-major across pairs;
    at most ``resident`` run at once and a random one moves at each
    step.  A band computes its rows a column at a time (a column of a band
    is a running max down its rows); before each chunk of ``chunk``
    columns it waits until the band above has published that many
    columns of its carry row.  The band's last row goes into the carry
    row below, and the column count is published after every chunk.  A
    carry value is poisoned until written, so a read before its
    publication shows."""
    B, la = a.shape
    lb = b.shape[1]
    S, h, nb = nw.plan(la, strip)
    poison = -(10**9)
    carry = np.full((B, max(nb - 1, 0), lb), poison, dtype=np.int64)
    done = np.zeros((B, max(nb - 1, 0)), dtype=np.int64)
    out = np.zeros(B, dtype=np.int64)

    def band(ticket):
        k, p = divmod(ticket, B)
        rows = np.arange(k * h, min((k + 1) * h, la))
        col = np.zeros(len(rows), dtype=np.int64)  # W at column 0
        top_prev = 0
        for c0 in range(0, lb, chunk):
            n = min(chunk, lb - c0)
            if k > 0:
                while done[p, k - 1] < c0 + n:
                    yield "wait"
                top = carry[p, k - 1, c0:c0 + n].copy()
                assert (top != poison).all(), "carry read before publication"
            else:
                top = np.zeros(n, dtype=np.int64)
            for x in range(n):
                j = c0 + x + 1
                match = a[p, rows] == b[p, j - 1]
                above = np.concatenate([[top_prev], col[:-1]])
                cand = np.maximum(above + np.where(match, 3, 1), col)
                col = np.maximum.accumulate(
                    np.concatenate([[top[x]], cand]))[1:]
                top_prev = top[x]
                if k < nb - 1:
                    carry[p, k, j - 1] = col[-1]
            if k < nb - 1:
                done[p, k] = c0 + n
            yield
        if k == nb - 1:
            out[p] = col[-1] - la - lb

    rng = np.random.default_rng(seed)
    running, nxt = [], 0
    while running or nxt < B * nb:
        while len(running) < resident and nxt < B * nb:
            running.append(band(nxt))
            nxt += 1
        i = int(rng.integers(len(running)))
        try:
            while next(running[i]) == "wait":
                assert len(running) > 1, "band pipeline deadlock"
                i = int(rng.integers(len(running)))
        except StopIteration:
            running.pop(i)
    return out, nb


@pytest.mark.parametrize("la,lb,want_nb", [(1, 9, 1), (40, 33, 1),
                                           (65, 40, 2), (130, 17, 3),
                                           (200, 50, 4), (300, 70, 5)])
def test_band_twin_matches_plain(la, lb, want_nb):
    """Bands of at most 64 rows (a strip of 2), heights that do not
    divide la, 1 to 5 bands, carry rows handed over in chunks of 8
    columns, in a seeded interleaving."""
    rng = np.random.default_rng(la + lb)
    a = rng.integers(0, 4, size=(3, la))
    b = rng.integers(0, 4, size=(3, lb))
    for resident in (2, 7):
        got, nb = _band_twin(a, b, strip=2, chunk=8, resident=resident,
                             seed=la * resident)
        assert nb == want_nb
        want = nw.pairwise_nw_scores_plain(torch.from_numpy(a).int(),
                                           torch.from_numpy(b).int())
        np.testing.assert_array_equal(got, want.numpy())


def _family(k=4, n=96, seed=5):
    """The inputs of tests/test_rotation_verification.py."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, size=n, dtype=np.int64)
    encoded = [base.copy()]
    shifts = [0]
    for _ in range(k - 1):
        sh = int(rng.integers(1, n))
        row = np.roll(base, sh).copy()
        for _ in range(2):
            row[int(rng.integers(0, n))] = int(rng.integers(0, 4))
        encoded.append(row)
        shifts.append(sh)
    return encoded, shifts


def _wrong(encoded, shifts):
    wrong = list(shifts)
    wrong[2] = (shifts[2] + len(encoded[2]) // 2) % len(encoded[2])
    return wrong


@pytest.mark.parametrize("case", ["correct", "wrong"])
def test_oracle_matches_jax(case):
    if case == "correct":
        encoded, rotations = _family()
        samples = 8
    else:
        encoded, shifts = _family(seed=9)
        rotations, samples = _wrong(encoded, shifts), 5
    jlog, tlog = io.StringIO(), io.StringIO()
    want = jverification.verify_rotations(encoded, rotations,
                                          samples=samples, log=jlog,
                                          interpret=True)
    got = verification.verify_rotations(encoded, rotations, device="cpu",
                                        samples=samples, log=tlog)
    assert got.num_checked == want.num_checked
    assert got.num_confirmed == want.num_confirmed
    np.testing.assert_array_equal(got.margins, want.margins)
    np.testing.assert_array_equal(got.chosen_scores, want.chosen_scores)
    assert tlog.getvalue() == jlog.getvalue()


def test_wrong_rotation_flagged():
    encoded, shifts = _family(seed=9)
    sink = io.StringIO()
    res = verification.verify_rotations(encoded, _wrong(encoded, shifts),
                                        device="cpu", samples=5, log=sink)
    assert not res.all_confirmed
    assert (res.margins < 0).sum() == res.num_checked - res.num_confirmed
    assert "WARNING sequence 2" in sink.getvalue()


def test_chunked_and_unchunked_scores_equal():
    """The JAX oracle cut the batch into 48-row chunks for the TPU's VMEM;
    the port runs it in one launch.  The scores agree."""
    encoded, shifts = _family(k=9, n=150, seed=4)
    a, b = verification.oracle_batch(encoded, shifts)
    whole = nw.pairwise_nw_scores(a, b, "cpu")
    per_seq = 9
    rows = (48 // per_seq) * per_seq
    parts = [nw.pairwise_nw_scores(a[i:i + rows], b[i:i + rows], "cpu")
             for i in range(0, len(a), rows)]
    assert len(parts) > 1
    torch.testing.assert_close(torch.cat(parts), whole, rtol=0, atol=0)


def test_cli_confirmed_line_matches_jax(tmp_path, monkeypatch, capsys):
    encoded, _ = _family(k=3, n=64, seed=2)
    chars = np.frombuffer(b"ACGT", dtype=np.uint8)
    fasta = tmp_path / "fam.fasta"
    with open(fasta, "w") as f:
        for i, e in enumerate(encoded):
            f.write(f">s{i}\n{chars[e].tobytes().decode()}\n")
    real = pallas_nw.pairwise_nw_scores
    monkeypatch.setattr(
        pallas_nw, "pairwise_nw_scores",
        lambda a, b, **kw: real(a, b, **{**kw, "interpret": True}))
    monkeypatch.chdir(tmp_path)

    def oracle_lines(main, *extra):
        assert main(["R", "fam.fasta", "--verify-rotations", *extra]) == 0
        return [l for l in capsys.readouterr().out.splitlines()
                if "pairwise NW oracle" in l or "WARNING sequence" in l]

    want = oracle_lines(jcli.main)
    got = oracle_lines(cli.main, "--device", "cpu")
    assert got == want and got[0].endswith(" confirmed")
