"""Every input and label token of every step in the window, over the
window's wall (clock read after a synchronize)."""

from portbench.bench.stats import rate


def read(run):
    return rate(run.window.get("tokens", 0), run.window.get("wall_s", 0))
