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
    """The kernel's launch plan: S x T x bands covers every row, T is a
    whole number of warps within the strip's thread cap, and one band is
    used whenever a strip width allows it."""
    S, T, bands = nw.plan(la)
    cap = dict(nw.STRIPS)[S]
    assert T % 32 == 0 and 32 <= T <= cap
    assert S * T * bands >= la > S * T * (bands - 1)
    assert (bands == 1) == (la <= max(s * t for s, t in nw.STRIPS))


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
