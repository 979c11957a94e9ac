"""The slot engine's 95th percentile, over every request due in the
window, of its first token's time from when it was due (`first_token_at -
arrival_s`); one that never produced one counts as infinitely late."""

from portbench.bench.stats import percentile


def read(run):
    p = percentile(run.window.get("ttft_s", []), 95)
    return None if p is None else 1e3 * p
