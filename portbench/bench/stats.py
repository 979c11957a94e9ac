"""Rates and tails as the benchmark reports them: a rate is all the work
over all the time of the window; a tail is over every request, and a
percentile is given only where at least `MIN_BEYOND` samples lie beyond it."""

from __future__ import annotations

import math
from typing import Optional, Sequence

MIN_BEYOND = 10


def rate(work: float, seconds: float) -> Optional[float]:
    if seconds <= 0 or work <= 0:
        return None
    return work / seconds


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics, or None where fewer than MIN_BEYOND samples lie above it.
    A missing value (None: a request that failed or never came) counts as
    infinitely late."""
    xs = sorted(math.inf if v is None else float(v) for v in values)
    n = len(xs)
    if n == 0 or n * (1.0 - q / 100.0) < MIN_BEYOND:
        return None
    pos = (n - 1) * q / 100.0
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    if math.isinf(xs[hi]) and frac > 0 or math.isinf(xs[lo]):
        return math.inf
    return xs[lo] + (xs[hi] - xs[lo]) * frac
