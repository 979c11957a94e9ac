"""The slot engine's 95th percentile, over every request due in the
window, of its end from when it was due (`finished_at - arrival_s`); one
that never finished counts as infinitely late."""

from portbench.bench.stats import percentile


def read(run):
    p = percentile(run.window.get("latency_s", []), 95)
    return None if p is None else 1e3 * p
