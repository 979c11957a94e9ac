"""95th percentile of the slot engine's queue wait, `admitted_at -
arrival_s` (the program's own stamps), over every request due."""

from portbench.bench.stats import percentile


def read(run):
    p = percentile(run.window.get("queue_s", []), 95)
    return None if p is None else 1e3 * p
