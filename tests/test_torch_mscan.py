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

