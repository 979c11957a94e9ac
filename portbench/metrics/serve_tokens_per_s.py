"""Every token the engine emitted in the window (each active slot's token
of each decode step) over the window's wall."""

from portbench.bench.stats import rate


def read(run):
    return rate(run.window.get("tokens", 0), run.window.get("wall_s", 0))
