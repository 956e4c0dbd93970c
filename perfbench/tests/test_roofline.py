"""The frozen bound arithmetic gives the bounds PERF.md keeps for the
port's kernels (NVIDIA H100 SXM peaks)."""

import pytest

from perfbench import roofline


def test_mscan_bound_at_12_x_8003584():
    assert roofline.mscan_bound_s(12, 8_003_584, False) * 1e3 == \
        pytest.approx(0.229, abs=5e-4)


def test_mscan_reduced_writes_one_row():
    full = roofline.mscan_bound_s(12, 1 << 20, False)
    reduced = roofline.mscan_bound_s(12, 1 << 20, True)
    assert reduced == pytest.approx(full * 13 / 24)


def test_profile_dp_bound_at_8_x_8192_squared():
    assert roofline.profile_bound_s([(8192, 8192)] * 8) * 1e3 == \
        pytest.approx(0.321, abs=5e-4)


def test_bound_takes_the_larger_side():
    assert roofline.bound_s(roofline.MEM_BYTES_PER_S, 0) == 1.0
    assert roofline.bound_s(0, roofline.INT32_OPS_PER_S) == 1.0
    assert roofline.INT32_OPS_PER_S == 132 * 64 * 1.98e9
