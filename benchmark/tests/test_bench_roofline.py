"""The roofline arithmetic on known shapes."""

import numpy as np
import pytest

from harness import roofline


def test_square_raw_is_operation_bound():
    # 8,192 records: 33,550,336 pairs x 29,903 sites x 18 channels
    least = roofline.counter_least_s(33_550_336, 29_903, 8192, "raw")
    assert least == pytest.approx(2 * 33_550_336 * 29_903 * 18 / 1979e12)
    assert least == pytest.approx(18.25e-3, rel=1e-3)


def test_channels_follow_the_measure():
    per = {m: roofline.counter_least_s(10 ** 9, 1000, 10, m)
           for m in roofline.CHANNELS}
    assert per["raw"] / per["tn93"] == pytest.approx(18 / 5)
    assert per["n"] == per["n_high"] and per["raw"] == per["jc69"]
    assert per["k80"] / per["n"] == pytest.approx(6 / 14)


def test_byte_bound_when_few_pairs():
    # one pair of very long records: reading the codes takes longer
    least = roofline.counter_least_s(1, 4_411_532, 2, "n")
    assert least == pytest.approx(2 * 4_411_532 / 3.35e12)


def test_variable_sites():
    chars = np.frombuffer(b"ACGTN" b"ACGAN" b"ACGTN", np.uint8).reshape(3, 5)
    # column 3 varies (T/A); column 4 is all N, which is no exact base
    assert roofline.variable_sites(chars) == 2
    low = np.frombuffer(b"acgt" b"ACGT", np.uint8).reshape(2, 4)
    assert roofline.variable_sites(low) == 0
