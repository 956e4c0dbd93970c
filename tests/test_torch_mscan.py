"""Port mscan (csa_tpu_torch.index.mscan) against the JAX package's
Pallas kernel run in interpret mode, over the shapes and options of
tests/test_mscan.py.  All values are int32, so every comparison is exact.
The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest
import torch

from csa_tpu.index import mscan as jmscan
from csa_tpu_torch import kernels
from csa_tpu_torch.index import mscan
from torch_mscan_inputs import KINDS, mscan_input

torch.set_num_threads(1)


def _x(M, N, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(2**30), 2**30, size=(M, N)).astype(np.int32)


@pytest.mark.parametrize("M,N", [(1, 100), (3, 2048), (12, 5000),
                                 (16, 2047), (26, 4097)])
def test_multi_cummax_matches_pallas(M, N):
    x = _x(M, N, M * 1000 + N)
    want = np.asarray(jmscan.multi_cummax(x, interpret=True,
                                          force_kernel=True))
    got = mscan.multi_cummax(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reverse,reduce", [(True, False), (False, True),
                                            (True, True)])
def test_multi_cummax_options_match_pallas(reverse, reduce):
    x = _x(13, 2500, 11 + 2 * reverse + reduce)
    want = np.asarray(jmscan.multi_cummax(
        x, reverse=reverse, min_over_channels=reduce, interpret=True,
        force_kernel=True))
    got = mscan.multi_cummax(torch.from_numpy(x), reverse=reverse,
                             min_over_channels=reduce).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("reverse,reduce", [(False, False), (True, True)])
def test_multi_cummin_matches_pallas(reverse, reduce):
    x = _x(9, 2100, 13 + reverse)
    want = np.asarray(jmscan.multi_cummin(
        x, reverse=reverse, max_over_channels=reduce, interpret=True,
        force_kernel=True))
    got = mscan.multi_cummin(torch.from_numpy(x), reverse=reverse,
                             max_over_channels=reduce).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensor_takes_plain_version_without_launch():
    kernels.reset_counts()
    x = torch.from_numpy(_x(4, 999, 17))
    got = mscan.multi_cummax(x)
    assert torch.equal(got, torch.cummax(x, 1).values)
    assert kernels.COUNTS["mscan"] == 0


def test_wrapper_raises_for_other_devices():
    x = torch.empty((2, 3), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        mscan.multi_cummax(x)



# --- a numpy twin of csrc/mscan.cu's schedule -------------------------------

AGGREGATE, PREFIX = 1, 2


def _lookback_twin(x, *, reverse, reduce, is_min, tile=mscan.TILE,
                   window=32, resident=6, seed=0):
    """The kernel's single pass, block by block, in a seeded interleaving.

    Blocks take tickets in order (tile-major across channels, or one tile
    across every channel with ``reduce``); at most ``resident`` run at
    once, and a random one moves at each step.  A block loads its tile's
    physical words [base, base + tile) (the identity outside [0, N)),
    reads them back to front when reversed, publishes its aggregate as
    (status << 32 | value), then looks back ``window`` descriptors at a
    time until it finds an inclusive prefix, waiting while any of them
    is empty, and publishes its own prefix (the kernel's window is one
    warp, 32)."""
    op = np.minimum if is_min else np.maximum
    red = np.maximum if is_min else np.minimum
    ident = np.iinfo(np.int32).max if is_min else np.iinfo(np.int32).min
    red_ident = np.iinfo(np.int32).min if is_min else np.iinfo(np.int32).max
    M, N = x.shape
    ntiles = max(1, -(-N // tile))
    desc = np.zeros((M, ntiles), dtype=np.int64)
    out = np.full((N,) if reduce else (M, N), 7, dtype=np.int32)

    def word(status, value):
        return (status << 32) | (int(value) & 0xFFFFFFFF)

    def value(d):
        return np.int32(np.uint32(d & 0xFFFFFFFF).view(np.int32))

    def block(ticket):
        t = ticket if reduce else ticket // M
        chans = range(M) if reduce else [ticket - t * M]
        p0 = t * tile
        base = N - p0 - tile if reverse else p0
        phys = np.arange(base, base + tile)
        inside = (phys >= 0) & (phys < N)
        acc = np.full(tile, red_ident, dtype=np.int32)
        for m in chans:
            sh = np.full(tile, ident, dtype=np.int32)
            sh[inside] = x[m, phys[inside]]
            items = sh[::-1] if reverse else sh
            items = op.accumulate(items)
            agg = items[-1]
            yield
            if t == 0:
                desc[m, 0] = word(PREFIX, agg)
                carry = ident
            else:
                desc[m, t] = word(AGGREGATE, agg)
                carry = ident
                pos = t - 1
                while True:
                    idx = pos - np.arange(window)
                    ds = [desc[m, i] if i >= 0 else word(PREFIX, ident)
                          for i in idx]
                    while any(d >> 32 == 0 for d in ds):
                        yield "wait"
                        ds = [desc[m, i] if i >= 0 else word(PREFIX, ident)
                              for i in idx]
                    stops = [k for k, d in enumerate(ds) if d >> 32 == PREFIX]
                    stop = stops[0] if stops else window - 1
                    for d in ds[:stop + 1]:
                        carry = op(carry, value(d))
                    if stops:
                        break
                    pos -= window
                desc[m, t] = word(PREFIX, op(carry, agg))
            items = op(items, carry)
            if reduce:
                acc = red(acc, items)
            else:
                sh = items[::-1] if reverse else items
                out[m, phys[inside]] = sh[inside]
            yield
        if reduce:
            sh = acc[::-1] if reverse else acc
            out[phys[inside]] = sh[inside]

    rng = np.random.default_rng(seed)
    total = ntiles if reduce else ntiles * M
    running, nxt = [], 0
    while running or nxt < total:
        while len(running) < resident and nxt < total:
            running.append(block(nxt))
            nxt += 1
        k = int(rng.integers(len(running)))
        try:
            while next(running[k]) == "wait":
                # a waiting block must wait on a running one
                assert len(running) > 1, "look-back deadlock"
                k = int(rng.integers(len(running)))
        except StopIteration:
            running.pop(k)
    return out


_T = mscan.TILE


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("N", [1, _T - 1, _T, _T + 1, 3 * _T, 3 * _T + 1,
                               3 * _T - 1])
@pytest.mark.parametrize("is_min", [False, True], ids=["max", "min"])
def test_lookback_twin_matches_plain(N, is_min, kind):
    """The twin at the kernel's tile, every option, at N = 1, at tile
    multiples and at tile multiples +- 1, on i.i.d. values, the collect
    cascade's channels and drifting walks (records in every tile)."""
    plain = mscan.multi_cummin_plain if is_min else mscan.multi_cummax_plain
    kw = "max_over_channels" if is_min else "min_over_channels"
    for reverse in (False, True):
        x = mscan_input(kind, 3, N, is_min=is_min, reverse=reverse,
                        seed=N + is_min)
        for reduce in (False, True):
            got = _lookback_twin(x, reverse=reverse, reduce=reduce,
                                 is_min=is_min, seed=N)
            want = plain(torch.from_numpy(x), reverse=reverse,
                         **{kw: reduce}).numpy()
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("reverse,reduce", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_lookback_twin_many_windows(reverse, reduce, kind):
    """Small tiles and a short window: the look-back crosses many windows
    of aggregates before it meets a prefix."""
    x = mscan_input(kind, 4, 997, is_min=False, reverse=reverse,
                    seed=31 + 2 * reverse + reduce)
    got = _lookback_twin(x, reverse=reverse, reduce=reduce, is_min=False,
                         tile=8, window=4, resident=40, seed=5)
    want = mscan.multi_cummax_plain(torch.from_numpy(x), reverse=reverse,
                                    min_over_channels=reduce).numpy()
    np.testing.assert_array_equal(got, want)


def test_scratch_words_cover_descriptors():
    assert mscan.scratch_words(12, 8_003_584) == 1 + 12 * 1954
    assert mscan.scratch_words(1, 1) == 2
    assert mscan.scratch_words(3, _T) == 4
    assert mscan.scratch_words(3, _T + 1) == 7
