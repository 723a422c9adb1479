"""The least-time functions against counts made by hand at tiny shapes."""

import pytest

from portbench import roofline as rf

BW, FL = 3.35e12, 67e12


def test_spmv_bytes_and_flops():
    # 10 rows, 40 edges, "mul": indices and weights 8 B an edge, offsets,
    # x and y 12 B a row = 440 B; 80 flops
    assert rf.spmv_least_s(10, 40) == pytest.approx(max(440 / BW, 80 / FL))
    assert rf.spmv_least_s(10, 40, "left") == pytest.approx(
        max(280 / BW, 40 / FL))


def test_spmm_bytes_and_flops():
    # n=3, m=5, F=2: offsets 16 B, edges 40 B, X and Y 48 B; 20 flops
    assert rf.spmm_least_s(3, 5, 2) == pytest.approx(max(104 / BW, 20 / FL))
    assert rf.spmm_least_s(3, 5, 2, weighted=False) == pytest.approx(
        84 / BW)


def test_gemm_compute_bound_at_width():
    rows, k, cols = 1 << 20, 256, 256
    flops = 2 * rows * k * cols
    assert rf.gemm_least_s(rows, k, cols) == pytest.approx(flops / FL)
    assert rf.gemm_least_s(2, 3, 4) == pytest.approx(
        4 * (6 + 12 + 8) / BW)


def test_sage_step_by_hand():
    # n=4 vertices, m=6 stored edges, 2 layers 3 -> 5 -> 2
    n, m = 4, 6
    agg = rf.spmm_least_s(n, m, 3) + rf.spmm_least_s(n, m, 5)  # forward
    agg += rf.spmm_least_s(n, m, 5)                              # one VJP
    gemm = 2 * (rf.gemm_least_s(n, 3, 5) + rf.gemm_least_s(n, 5, 2))
    gemm += 2 * (rf.gemm_least_s(3, n, 5) + rf.gemm_least_s(5, n, 2))
    gemm += 2 * rf.gemm_least_s(n, 2, 5)
    params = (2 * 3 * 5 + 5) + (2 * 5 * 2 + 2)
    want = agg + gemm + 28 * params / BW
    assert rf.sage_step_least_s(n, m, 3, 5, 2, 2) == pytest.approx(want)
    assert rf.sage_aggregations(100, 256, 47, 3) == ([100, 256, 256],
                                                     [256, 256])
