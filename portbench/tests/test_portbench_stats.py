"""The window's end-to-end statistics, by hand."""

import pytest

from portbench import harness


def test_call_ms_is_the_window_over_the_calls():
    stats = harness.call_stats([0.1, 0.2, 0.3, 0.4], window_s=1.0)
    assert stats["call_ms"] == pytest.approx(250.0)


def test_call_p95_is_taken_over_every_call():
    walls = [0.010] * 95 + [0.050] * 5  # 100 calls, the slowest 5 % at 50 ms
    stats = harness.call_stats(walls, window_s=sum(walls))
    # the 95th percentile of all 100 walls lies between the 95th and 96th (inclusive method)
    assert stats["call_p95_ms"] == pytest.approx(10.0 + 0.05 * 40.0)
    walls = list(range(1, 201))  # 1..200 s: the inclusive 95th percentile is 190.05
    assert harness.call_stats(walls, 1.0)["call_p95_ms"] == pytest.approx(190050.0)
