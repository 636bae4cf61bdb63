"""K1's bytes, operations and least time on a shape worked by hand."""

import pytest

import roofline


def test_k1_launch_at_chr21():
    # R=1, K=10, 672 x 768 padded grid: 516,096 pixels
    nbytes, ops = roofline.k1_launch(1, 10, 672, 768, 8)
    assert nbytes == 4 * (3 * 10 + 4) * 516096 == 70189056
    assert ops == 8 * 27 * 10 * 516096 == 1114767360
    # bytes bound: 70.19 MB / 3.35 TB/s = 20.95 us > 1.115 GFLOP / 67 TFLOP/s
    assert roofline.least_s(nbytes, ops) == pytest.approx(20.952e-6,
                                                          rel=1e-4)
    # five temperatures, one launch each
    assert roofline.k1_mean_field_least_s(1, 10, 672, 768, 1) == \
        pytest.approx(5 * 20.952e-6, rel=1e-4)


def test_k1_two_launches_a_temperature_at_k20():
    # two launches of 4 sweeps: each reads and writes it all once
    one, ops4 = roofline.k1_launch(1, 20, 704, 768, 4)
    assert one == 4 * 64 * 540672
    least = roofline.k1_mean_field_least_s(1, 20, 704, 768, 2)
    assert least == pytest.approx(5 * 2 * one / 3.35e12)
