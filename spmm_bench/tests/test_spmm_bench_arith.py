"""The yardstick's operation and byte arithmetic on hand-worked cases."""
import statistics

import pytest

from spmm_bench import arith


def test_spmm_counts_by_hand():
    # 3 x 3 with 5 nonzeros, k = 2: 2·5·2 operations; bytes: 5 indices and
    # 5 values (40), 4 row pointers (16), B 3·2 and C 3·2 floats (24 + 24)
    assert arith.spmm_flops(5, 2) == 20
    assert arith.spmm_bytes(3, 3, 5, 2) == 104
    assert arith.spmm_least_s(3, 3, 5, 2) == pytest.approx(104 / 3.35e12)
    # 10^6 nonzeros in one row and column, k = 100: 2·10^8 operations take
    # 2.99 us at the peak, 8,000,808 bytes 2.39 us: the operations bound
    assert arith.spmm_bytes(1, 1, 10**6, 100) == 8_000_808
    assert arith.spmm_least_s(1, 1, 10**6, 100) == pytest.approx(
        2e8 / 67e12)


def test_reddit_headline_bound():
    # 23,446,803·8 + 232,966·4 + 2·232,965·128·4 = 427,062,448 bytes
    b = arith.spmm_bytes(232_965, 232_965, 23_446_803, 128)
    assert b == 427_062_448
    assert arith.spmm_least_s(232_965, 232_965, 23_446_803, 128) == \
        pytest.approx(b / 3.35e12)


def test_gcn_counts_by_hand():
    # m = 2, nnz = 3, 4 -> 3 -> 2: forward 2·2·4·3 + 2·3·3 + 2·2·3·2 +
    # 2·3·2 = 48 + 18 + 24 + 12; a step adds 18 + 12 (transposed SpMMs),
    # 48 (W1's gradient) and 2·24 (W2's and H's)
    assert arith.gcn_forward_flops(2, 3, 4, 3, 2) == 102
    assert arith.gcn_train_step_flops(2, 3, 4, 3, 2) == 102 + 30 + 48 + 48


def test_reddit_and_flickr_model_flops():
    step = arith.gcn_train_step_flops(232_965, 23_446_803, 602, 128, 41)
    assert step / 1e9 == pytest.approx(95.0, abs=0.05)
    fwd = arith.gcn_forward_flops(89_250, 989_006, 500, 128, 7)
    assert fwd / 1e9 == pytest.approx(11.85, abs=0.01)


def test_percentile_and_spread():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert arith.percentile(xs, 50) == 3.0
    assert arith.percentile(xs, 95) == pytest.approx(4.8)
    assert arith.percentile([7.0], 95) == 7.0
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert arith.spread(xs) == pytest.approx((q3 - q1) / q2)
    with pytest.raises(ValueError):
        arith.percentile([], 50)
