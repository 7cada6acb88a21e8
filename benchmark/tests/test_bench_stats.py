"""The benchmark's frozen arithmetic."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import stats


def test_rate_is_over_the_whole_window():
    assert stats.rate(200, 20.0) == 10.0


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_over_every_value_as_numpy(q):
    v = np.random.default_rng(3).lognormal(size=1001)
    assert stats.percentile(v, q) == pytest.approx(np.percentile(v, q), rel=1e-12)


def test_p95_counts_every_sample():
    v = [1.0] * 95 + [100.0] * 5
    assert stats.percentile(v, 95) == pytest.approx(1.0 + 99.0 * 0.05)


def test_busy_is_the_union_of_intervals():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.6), (10.0, 10.0)]
    assert stats.busy(iv) == pytest.approx(4.0)
    assert stats.gaps(iv, -1.0, 12.0) == [(-1.0, 1.0), (3.0, 2.0), (6.0, 4.0), (10.0, 2.0)]


def test_bound_takes_the_slower_of_bytes_and_operations():
    ms, by = stats.bound_ms(3.35e9, 1.0)
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = stats.bound_ms(1.0, 67e9)
    assert by == "operations" and ms == pytest.approx(1.0)


def test_ate_against_own_first_frame():
    T = [np.eye(4) for _ in range(3)]
    ref = [np.eye(4) for _ in range(3)]
    for i, t in enumerate(ref):
        t[0, 3] = 10.0 + i
    est = [t.copy() for t in ref]
    est[2][0, 3] += 0.03
    assert stats.ate_rmse(T, T) == 0.0
    assert stats.ate_rmse(est, ref) == pytest.approx(0.03 / np.sqrt(3))
