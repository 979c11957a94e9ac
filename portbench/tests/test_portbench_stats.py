"""Rates over all the work and time; tails over every request, with at
least ten samples beyond the percentile, and a missing request as late."""

import math

from portbench.tests import tiny  # noqa: F401
from portbench.bench import stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(1000, 4.0) == 250.0
    assert stats.rate(0, 4.0) is None


def test_p95_needs_ten_samples_beyond_it():
    assert stats.percentile(list(range(199)), 95) is None
    assert stats.percentile(list(range(200)), 95) is not None


def test_p95_over_all_requests():
    values = list(range(1, 201))
    assert abs(stats.percentile(values, 95) - 190.05) < 1e-9


def test_missing_request_counts_as_late():
    values = [1.0] * 189 + [None] * 11
    assert math.isinf(stats.percentile(values, 95))
    values = [1.0] * 195 + [None] * 5
    assert stats.percentile(values, 95) == 1.0
